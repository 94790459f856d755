"""Preprocessing config (paths & prefixes).

Parity with reference include/silo/preprocessing/preprocessing_config.h:
defaults, plus the layered merge (user file over default file over hardcoded,
reference src/silo_api/api.cpp:35-59) implemented in `read_layered`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import yaml

_DEFAULTS = {
    "inputDirectory": "./",
    "outputDirectory": "./output/",
    "intermediateResultsDirectory": "./temp/",
    "metadataFilename": "metadata.tsv",
    "ndjsonInputFilename": None,
    "pangoLineageDefinitionFilename": None,
    "referenceGenomeFilename": "reference_genomes.json",
    "nucleotideSequencePrefix": "nuc_",
    "unalignedNucleotideSequencePrefix": "unaligned_",
    "genePrefix": "gene_",
}


@dataclass
class PreprocessingConfig:
    input_directory: str = "./"
    output_directory: str = "./output/"
    intermediate_results_directory: str = "./temp/"
    metadata_filename: str = "metadata.tsv"
    ndjson_input_filename: str | None = None
    pango_lineage_definition_filename: str | None = None
    reference_genome_filename: str = "reference_genomes.json"
    nucleotide_sequence_prefix: str = "nuc_"
    unaligned_nucleotide_sequence_prefix: str = "unaligned_"
    gene_prefix: str = "gene_"

    def _in(self, filename: str) -> str:
        return os.path.join(self.input_directory, filename)

    def metadata_path(self) -> str:
        return self._in(self.metadata_filename)

    def ndjson_path(self) -> str | None:
        return self._in(self.ndjson_input_filename) if self.ndjson_input_filename else None

    def pango_lineage_definition_path(self) -> str | None:
        if self.pango_lineage_definition_filename is None:
            return None
        return self._in(self.pango_lineage_definition_filename)

    def reference_genome_path(self) -> str:
        return self._in(self.reference_genome_filename)

    def nuc_filename_no_extension(self, name: str) -> str:
        return self._in(self.nucleotide_sequence_prefix + name)

    def unaligned_nuc_filename_no_extension(self, name: str) -> str:
        return self._in(self.unaligned_nucleotide_sequence_prefix + name)

    def gene_filename_no_extension(self, name: str) -> str:
        return self._in(self.gene_prefix + name)


def _from_dict(data: dict) -> PreprocessingConfig:
    merged = dict(_DEFAULTS)
    merged.update({k: v for k, v in data.items() if v is not None})
    return PreprocessingConfig(
        input_directory=merged["inputDirectory"],
        output_directory=merged["outputDirectory"],
        intermediate_results_directory=merged["intermediateResultsDirectory"],
        metadata_filename=merged["metadataFilename"],
        ndjson_input_filename=merged["ndjsonInputFilename"],
        pango_lineage_definition_filename=merged["pangoLineageDefinitionFilename"],
        reference_genome_filename=merged["referenceGenomeFilename"],
        nucleotide_sequence_prefix=merged["nucleotideSequencePrefix"],
        unaligned_nucleotide_sequence_prefix=merged["unalignedNucleotideSequencePrefix"],
        gene_prefix=merged["genePrefix"],
    )


def read_preprocessing_config(path) -> PreprocessingConfig:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return _from_dict(data)


def read_layered(cli_path: str | None = None, cwd: str = ".") -> PreprocessingConfig:
    """CLI-named file > ./preprocessing_config.yaml >
    ./default_preprocessing_config.yaml > hardcoded defaults."""
    data: dict = {}
    for candidate in [
        os.path.join(cwd, "default_preprocessing_config.yaml"),
        os.path.join(cwd, "preprocessing_config.yaml"),
        cli_path,
    ]:
        if candidate and os.path.exists(candidate):
            with open(candidate) as f:
                layer = yaml.safe_load(f) or {}
            data.update({k: v for k, v in layer.items() if v is not None})
    return _from_dict(data)
