"""The port's ingest (``lapis_silo_torch.preprocessing``) against the JAX
package's.

The same seeded input files (``lapis_silo_torch.testing.write_ingest_inputs``)
go through the JAX package's ``Preprocessor`` and the port's, each with an
intermediate directory of its own (the resume workdir's signature is the
same for both packages, so a shared one would let the second run resume
from the first's committed stages). The two databases are equal in every
field but the data version: partitions, sequence counts, metadata columns
and dictionaries, every stored segment row, the unaligned and insertion
stores, and ``/info``; and a battery of queries answers equally, from the
JAX package's host engine and from the port's engine on the CPU. This holds
for the TSV + FASTA route (plain, ``.zst`` and ``.xz`` FASTA), the NDJSON
route (native scanner and ``SILO_NDJSON_NATIVE=0``), a resume after an
interrupted stage, and the sharded ingest, whose worker processes run the
port's module and load no module of ``jax*`` or ``lapis_silo_tpu*``. Both
packages refuse bad inputs with the same ``PreprocessingError``. Every value
is an integer, a string, a float read from text or a packed word: the
tolerance is equality."""

import dataclasses
import enum
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lapis_silo_torch
from lapis_silo_torch.config.database_config import get_validated_config
from lapis_silo_torch.preprocessing import preprocessing_config, readers
from lapis_silo_torch.preprocessing import spool as spool_mod
from lapis_silo_torch.preprocessing.preprocessor import (
    PreprocessingError,
    Preprocessor,
)
from lapis_silo_torch.preprocessing.sharded import sharded_preprocess
from lapis_silo_torch.query.engine import QueryEngine
from lapis_silo_torch.testing import write_ingest_inputs
from lapis_silo_tpu.config.database_config import (
    get_validated_config as ref_get_validated_config,
)
from lapis_silo_tpu.preprocessing import preprocessing_config as ref_pcfg_mod
from lapis_silo_tpu.preprocessing.preprocessor import (
    PreprocessingError as RefPreprocessingError,
)
from lapis_silo_tpu.preprocessing.preprocessor import (
    Preprocessor as RefPreprocessor,
)
from lapis_silo_tpu.preprocessing.sharded import (
    sharded_preprocess as ref_sharded_preprocess,
)
from lapis_silo_tpu.query.engine import QueryEngine as RefQueryEngine

BANNED = ("jax", "jaxlib", "lapis_silo_tpu")
SIZE = dict(n_rows=300, length=400, gene_length=50, p_unaligned=0.5, seed=11)
# fields that hold no data of the database: the version, engines, locks,
# lazily built caches and per-process handles of the native libraries
SKIP = {"data_version", "device_engine", "_engine", "_engine_lock",
        "_roaring_stats", "_compressor", "_decompressor", "_local",
        "_ids_fn", "_lut_addr"}


def assert_same(got, want, path="db", seen=None):
    """`got` (the port's) equals `want` (the JAX package's) field by field,
    recursively: arrays by dtype, shape and value (NaN equal to NaN), objects
    by class name and every attribute but SKIP."""
    seen = set() if seen is None else seen
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        assert isinstance(got, np.ndarray) and isinstance(want, np.ndarray), path
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, np.generic):
        assert type(got) is type(want), path
        assert got == want or (got != got and want != want), path
    elif isinstance(want, float):
        assert isinstance(got, float), path
        assert got == want or (got != got and want != want), path
    elif isinstance(want, (str, bytes, int, bool, type(None))):
        assert type(got) is type(want) and got == want, path
    elif isinstance(want, enum.Enum):
        assert (type(got).__name__, got.value) == (
            type(want).__name__, want.value), path
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for key in want:
            assert_same(got[key], want[key], f"{path}[{key!r}]", seen)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]", seen)
    elif isinstance(want, (set, frozenset)):
        assert got == want, path
    elif isinstance(want, type):  # a class held as a factory
        assert got.__name__ == want.__name__, path
    elif hasattr(want, "__dict__"):
        assert type(got).__name__ == type(want).__name__, path
        if id(want) in seen:
            return
        seen.add(id(want))
        fields = [k for k in vars(want) if k not in SKIP]
        assert [k for k in vars(got) if k not in SKIP] == fields, path
        for key in fields:
            assert_same(getattr(got, key), getattr(want, key),
                        f"{path}.{key}", seen)
    else:  # locks, ctypes handles, functions: their kind only
        assert type(got).__name__ == type(want).__name__, path


def queries(inputs) -> list[str]:
    """Every action, over filters of every kind the inputs reach."""
    mutated = int(inputs.mut_pos[0]) + 1
    symbol = "-ACGT"[int(inputs.mut_sym[0])]
    filters = [
        {"type": "True"},
        {"type": "NucleotideEquals", "position": mutated, "symbol": symbol},
        {"type": "Or", "children": [
            {"type": "HasNucleotideMutation", "position": mutated},
            {"type": "PangoLineage", "column": "pango_lineage",
             "value": "B.1.617.2", "includeSublineages": True}]},
        {"type": "And", "children": [
            {"type": "DateBetween", "column": "date", "from": "2021-02-01",
             "to": "2021-09-30"},
            {"type": "Not", "child": {"type": "StringEquals",
                                      "column": "country",
                                      "value": "Germany"}}]},
        {"type": "N-Of", "numberOfMatchers": 1, "matchExactly": False,
         "children": [
             {"type": "IntBetween", "column": "age", "from": 20, "to": 40},
             {"type": "FloatBetween", "column": "qc_value", "from": 0.9,
              "to": None},
             {"type": "StringEquals", "column": "is_reinfection",
              "value": "true"},
             {"type": "HasAminoAcidMutation", "sequenceName": "S",
              "position": 7}]},
    ]
    actions = [
        {"type": "Aggregated"},
        {"type": "Aggregated", "groupByFields": ["country"]},
        {"type": "Aggregated", "groupByFields": ["date", "pango_lineage"],
         "orderByFields": ["count"], "limit": 9},
        {"type": "Details", "fields": ["key", "date", "age", "qc_value",
                                       "is_reinfection", "pango_lineage"],
         "orderByFields": ["key"], "limit": 25},
        {"type": "Mutations", "minProportion": 0.01},
        {"type": "AminoAcidMutations", "minProportion": 0.01},
        {"type": "Insertions"},
        {"type": "AminoAcidInsertions"},
        {"type": "Fasta", "sequenceName": "main", "orderByFields": ["key"]},
        {"type": "FastaAligned", "sequenceName": ["main", "S"],
         "orderByFields": ["key"], "limit": 12},
    ]
    extra = [
        {"type": "InsertionContains", "position": 1, "value": ".*"},
        {"type": "AminoAcidEquals", "sequenceName": "S", "position": 3,
         "symbol": "X"},
        {"type": "PangoLineage", "column": "pango_lineage", "value": "BA.2",
         "includeSublineages": False},
    ]
    return ([json.dumps({"action": a, "filterExpression": f})
             for a in actions for f in filters]
            + [json.dumps({"action": {"type": "Aggregated"},
                           "filterExpression": f}) for f in extra])


def configs(inputs, intermediate):
    """(port's, JAX package's) configs of `inputs`, with their own
    intermediate directory under `intermediate`."""
    port = preprocessing_config.read_preprocessing_config(
        inputs.preprocessing_config)
    ref = ref_pcfg_mod.read_preprocessing_config(inputs.preprocessing_config)
    port.intermediate_results_directory = str(Path(intermediate) / "port")
    ref.intermediate_results_directory = str(Path(intermediate) / "ref")
    return ((port, get_validated_config(inputs.database_config)),
            (ref, ref_get_validated_config(inputs.database_config)))


def ingest_both(inputs, intermediate):
    (pcfg, dbconf), (ref_pcfg, ref_dbconf) = configs(inputs, intermediate)
    return (Preprocessor(pcfg, dbconf).preprocess(),
            RefPreprocessor(ref_pcfg, ref_dbconf).preprocess())


def assert_databases_equal(port, ref):
    assert type(port).__module__.startswith("lapis_silo_torch.")
    assert type(ref).__module__.startswith("lapis_silo_tpu.")
    assert port.data_version.value and ref.data_version.value
    assert [p.sequence_count for p in port.partitions] == [
        p.sequence_count for p in ref.partitions]
    assert_same(port, ref)
    assert port.info() == ref.info()
    assert port.detailed_info() == ref.detailed_info()


def assert_answers_equal(port, ref, inputs):
    """The JAX package's host engine, the port's host engine and the port's
    engine on the CPU answer every query alike."""
    battery = queries(inputs)
    want = [RefQueryEngine(ref, use_device=False).execute(q) for q in battery]
    host = QueryEngine(port, use_device=False)
    assert [host.execute(q) for q in battery] == want
    lapis_silo_torch.install(port, torch.device("cpu"))
    try:
        for query, expected in zip(battery, want):
            assert port.execute_query(query) == expected, query
    finally:
        port.device_engine = None
        port._engine = None
    assert sum(bool(w["queryResult"]) for w in want) > len(want) * 3 // 4


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """{(fmt, compression): IngestInputs} of one seed, written lazily."""
    root = tmp_path_factory.mktemp("ingest_inputs")
    written = {}

    def get(fmt, compression=None):
        key = (fmt, compression)
        if key not in written:
            written[key] = write_ingest_inputs(
                root / f"{fmt}_{compression}", fmt=fmt,
                compression=compression, **SIZE)
        return written[key]

    return get


@pytest.fixture(scope="module")
def ndjson_pair(inputs, tmp_path_factory):
    """The NDJSON inputs ingested by both packages (native scanner); the
    tests only compare them (a query would cache state on a database)."""
    return ingest_both(inputs("ndjson"), tmp_path_factory.mktemp("inter"))


ROUTES = [("ndjson", None, "1"), ("ndjson", None, "0"), ("ndjson", "zst", "1"),
          ("tsv", None, "1"), ("tsv", "zst", "1"), ("tsv", "xz", "1")]


@pytest.mark.parametrize("fmt,compression,native", ROUTES,
                         ids=[f"{f}-{c}-native{n}" for f, c, n in ROUTES])
def test_ingest_equals_the_jax_package(inputs, tmp_path, monkeypatch, fmt,
                                       compression, native):
    monkeypatch.setenv("SILO_NDJSON_NATIVE", native)
    data = inputs(fmt, compression)
    port, ref = ingest_both(data, tmp_path)
    assert len(port.partitions) == 4
    assert_databases_equal(port, ref)
    assert_answers_equal(port, ref, data)


def test_both_routes_build_one_database(ndjson_pair, inputs, tmp_path):
    """The TSV + FASTA files and the NDJSON file of one seed hold the same
    records: the port builds the same database from either."""
    (pcfg, dbconf), _ = configs(inputs("tsv", "xz"), tmp_path)
    assert_same(Preprocessor(pcfg, dbconf).preprocess(), ndjson_pair[0])


def test_writer_arrays_give_the_answers(inputs, tmp_path):
    """The writer's own arrays, counted with numpy, give the ingested
    database's per-country counts and NucleotideEquals counts."""
    data = inputs("ndjson")
    (pcfg, dbconf), _ = configs(data, tmp_path)
    port = Preprocessor(pcfg, dbconf).preprocess()
    got = port.execute_query(json.dumps({
        "action": {"type": "Aggregated", "groupByFields": ["country"]},
        "filterExpression": {"type": "True"}}))["queryResult"]
    assert {row["country"]: row["count"] for row in got} == (
        data.country_counts())
    assert None in data.country_counts()
    pairs = [(int(p) + 1, "-ACGT"[int(s)])
             for p, s in zip(data.mut_pos[:4], data.mut_sym[:4])]
    pairs += [(int(p) + 1, "ACGT"[k]) for k, p in enumerate(
        data.mut_pos[4:8])]
    for position, symbol in pairs:
        got = port.execute_query(json.dumps({
            "action": {"type": "Aggregated"},
            "filterExpression": {"type": "NucleotideEquals",
                                 "position": position, "symbol": symbol}}))
        assert got["queryResult"][0]["count"] == data.nucleotide_count(
            position, symbol), (position, symbol)
    assert data.null_sequence.sum() >= 2


LAYERS = {
    "cli": {"inputDirectory": "cli/", "ndjsonInputFilename": "in.ndjson"},
    "cwd": {"inputDirectory": "cwd/", "outputDirectory": "out_cwd/",
            "genePrefix": "g_"},
    "default": {"inputDirectory": "default/", "metadataFilename": "m.tsv",
                "intermediateResultsDirectory": "inter/"},
}


@pytest.mark.parametrize("present", [(), ("cli",), ("cwd",), ("default",),
                                     ("cwd", "default"),
                                     ("cli", "cwd", "default")])
def test_layered_config_equals_the_jax_package(tmp_path, present):
    """CLI file over ./preprocessing_config.yaml over
    ./default_preprocessing_config.yaml over the defaults."""
    import yaml

    names = {"cli": "cli.yaml", "cwd": "preprocessing_config.yaml",
             "default": "default_preprocessing_config.yaml"}
    for layer in present:
        (tmp_path / names[layer]).write_text(yaml.safe_dump(LAYERS[layer]))
    cli = str(tmp_path / "cli.yaml") if "cli" in present else None
    got = preprocessing_config.read_layered(cli, cwd=str(tmp_path))
    want = ref_pcfg_mod.read_layered(cli, cwd=str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    top = next((LAYERS[layer] for layer in ("cli", "cwd", "default")
                if layer in present), {"inputDirectory": "./"})
    assert got.input_directory == top["inputDirectory"]


def test_tsv_resume_after_an_interrupted_stage(inputs, tmp_path,
                                               monkeypatch):
    """Crash after the first FASTA stage committed: the re-run reads every
    FASTA file but that one and builds the JAX package's database."""
    data = inputs("tsv", "zst")
    (pcfg, dbconf), (ref_pcfg, ref_dbconf) = configs(data, tmp_path)
    real_iter = readers.iter_fasta
    calls = []

    def crashing_iter(stream):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("simulated crash mid-ingest")
        return real_iter(stream)

    monkeypatch.setattr(readers, "iter_fasta", crashing_iter)
    with pytest.raises(RuntimeError, match="simulated crash"):
        Preprocessor(pcfg, dbconf).preprocess()
    inter = pcfg.intermediate_results_directory
    (workdir,) = os.listdir(inter)
    committed = [f for f in os.listdir(os.path.join(inter, workdir))
                 if f.endswith(".stage.json")]
    assert any(f.startswith("scan") for f in committed)
    assert any(f.startswith("fasta_") for f in committed)
    calls.clear()
    monkeypatch.setattr(readers, "iter_fasta",
                        lambda stream: calls.append(1) or real_iter(stream))
    port = Preprocessor(pcfg, dbconf).preprocess()
    assert len(calls) == 2  # three FASTA files, one committed
    assert os.listdir(inter) == []
    assert_databases_equal(
        port, RefPreprocessor(ref_pcfg, ref_dbconf).preprocess())


def test_ndjson_resume_skips_the_scan(ndjson_pair, inputs, tmp_path,
                                      monkeypatch):
    """Crash while routing, after the scan committed: the re-run does not
    scan again and builds the same database."""
    (pcfg, dbconf), _ = configs(inputs("ndjson"), tmp_path)
    real_route = spool_mod.SequenceSpool.route
    calls = []

    def crashing_route(self, target, assignment):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("simulated crash mid-route")
        return real_route(self, target, assignment)

    monkeypatch.setattr(spool_mod.SequenceSpool, "route", crashing_route)
    with pytest.raises(RuntimeError, match="simulated crash"):
        Preprocessor(pcfg, dbconf).preprocess()
    monkeypatch.setattr(spool_mod.SequenceSpool, "route", real_route)

    def poisoned_scanner(*args, **kwargs):
        raise AssertionError("scan ran again despite the committed scan")

    monkeypatch.setattr(Preprocessor, "_make_ndjson_scanner",
                        poisoned_scanner)
    port = Preprocessor(pcfg, dbconf).preprocess()
    assert os.listdir(pcfg.intermediate_results_directory) == []
    assert_databases_equal(port, ndjson_pair[1])


SITE_HOOK = """
import atexit, json, os, sys

def _report():
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in {banned!r} and sys.modules[m])
    with open(os.path.join({out!r}, f"{{os.getpid()}}.json"), "w") as f:
        json.dump({{"argv": sys.argv, "banned": loaded}}, f)

atexit.register(_report)
"""


def test_sharded_ingest_equals_single_process(ndjson_pair, inputs, tmp_path,
                                              monkeypatch):
    """--ingestShards 2: the database of one process; both workers run
    python -m lapis_silo_torch.preprocessing.sharded and load no module of
    jax* or lapis_silo_tpu*."""
    hook, out = tmp_path / "hook", tmp_path / "reports"
    hook.mkdir()
    out.mkdir()
    (hook / "sitecustomize.py").write_text(
        SITE_HOOK.format(banned=BANNED, out=str(out)))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(hook)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    (pcfg, dbconf), _ = configs(inputs("ndjson"), tmp_path)
    port = sharded_preprocess(pcfg, dbconf, 2)
    reports = [json.loads(p.read_text()) for p in sorted(out.iterdir())]
    assert len(reports) == 2
    for report in reports:
        assert report["argv"][0] == str(
            Path(lapis_silo_torch.__file__).parent / "preprocessing"
            / "sharded.py")
        assert report["banned"] == []
    assert_databases_equal(port, ndjson_pair[1])


def _drop_column(directory, name):
    path = Path(directory) / "metadata.tsv"
    rows = [line.split("\t") for line in path.read_text().splitlines()]
    drop = rows[0].index(name)
    path.write_text("".join("\t".join(r[:drop] + r[drop + 1:]) + "\n"
                            for r in rows))


def _no_gene_in_first_record(directory):
    path = Path(directory) / "input_file.ndjson"
    lines = path.read_text().splitlines()
    record = json.loads(lines[0])
    record["alignedAminoAcidSequences"] = {}
    path.write_text("\n".join([json.dumps(record)] + lines[1:]) + "\n")


ERRORS = {
    "tsv-missing-column": ("tsv", lambda d: _drop_column(d, "age"), None,
                           "metadata field 'age'"),
    "ndjson-missing-gene": ("ndjson", _no_gene_in_first_record, None,
                            "does not contain the sequences ['S']"),
    "ndjson-absent": ("ndjson", lambda d: os.unlink(
        Path(d) / "input_file.ndjson"), None, "does not exist"),
    "fasta-missing-nuc": ("tsv", lambda d: os.unlink(
        Path(d) / "nuc_main.fasta"), None, "Missing aligned nucleotide"),
    "fasta-missing-gene": ("tsv", lambda d: os.unlink(
        Path(d) / "gene_S.fasta"), None, "Missing gene sequence file"),
    "sharded-tsv": ("tsv", lambda d: None, 2, "NDJSON input only"),
    "sharded-zero": ("ndjson", lambda d: None, 0, "invalid shard count"),
}


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_equal_the_jax_package(tmp_path, monkeypatch, case, native):
    fmt, breaks, shards, message = ERRORS[case]
    monkeypatch.setenv("SILO_NDJSON_NATIVE", native)
    data = write_ingest_inputs(tmp_path / "in", 40, 120, fmt=fmt,
                               gene_length=20, seed=2)
    breaks(data.directory)
    (pcfg, dbconf), (ref_pcfg, ref_dbconf) = configs(data, tmp_path)
    errors = []
    for package, run, pcfg_, dbconf_, error in (
            ("port", Preprocessor, pcfg, dbconf, PreprocessingError),
            ("ref", RefPreprocessor, ref_pcfg, ref_dbconf,
             RefPreprocessingError)):
        sharded = (sharded_preprocess if package == "port"
                   else ref_sharded_preprocess)
        with pytest.raises(error) as caught:
            if shards is None:
                run(pcfg_, dbconf_).preprocess()
            else:
                sharded(pcfg_, dbconf_, shards)
        errors.append(str(caught.value))
    assert errors[0] == errors[1]
    assert message in errors[0]


def test_the_port_ingest_imports_no_jax_module(inputs, tmp_path):
    """A fresh process ingests NDJSON with the port's Preprocessor and has
    loaded no module of jax* or lapis_silo_tpu*."""
    import subprocess

    script = f"""
import json, sys
from lapis_silo_torch.config.database_config import get_validated_config
from lapis_silo_torch.preprocessing.preprocessing_config import (
    read_preprocessing_config)
from lapis_silo_torch.preprocessing.preprocessor import Preprocessor
pcfg = read_preprocessing_config({inputs("ndjson").preprocessing_config!r})
pcfg.intermediate_results_directory = {str(tmp_path)!r}
db = Preprocessor(pcfg, get_validated_config(
    {inputs("ndjson").database_config!r})).preprocess()
assert db.info()["sequenceCount"] == {SIZE["n_rows"]}
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in {BANNED!r})))
"""
    repo = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(repo)
    done = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr
    assert json.loads(done.stdout.strip().splitlines()[-1]) == []


def test_scanner_built_against_the_zstd_declarations(inputs, tmp_path,
                                                     monkeypatch):
    """The port builds the NDJSON scanner against native_include/zstd.h and
    the loaded libzstd.so.1, so that it needs no zstd development files:
    that scanner gives the same records and blobs as the Python loop."""
    from lapis_silo_torch import native
    from lapis_silo_torch.preprocessing import native_ndjson
    from lapis_silo_torch.storage.reference_genomes import ReferenceGenomes

    lib = native._build_and_load("libsilo_ndjson.so", str(tmp_path / "lib"))
    if lib is None:
        pytest.skip("no C++ toolchain")
    assert Path(lib._name).parent == tmp_path / "lib"
    assert (tmp_path / "lib" / "zstd" / "libzstd.so").is_symlink()
    monkeypatch.setattr(native_ndjson, "get_named_lib", lambda name: lib)
    data = inputs("ndjson")
    genomes = ReferenceGenomes.read_from_file(
        Path(data.directory) / "reference_genomes.json")
    assert Preprocessor.__new__(Preprocessor)._make_ndjson_scanner(
        genomes)._lib is lib
    (pcfg, dbconf), _ = configs(data, tmp_path / "native")
    native_db = Preprocessor(pcfg, dbconf).preprocess()
    monkeypatch.setenv("SILO_NDJSON_NATIVE", "0")
    (pcfg, dbconf), _ = configs(data, tmp_path / "python")
    assert_same(native_db, Preprocessor(pcfg, dbconf).preprocess())
