"""The frozen corpus equals the port's synthetic corpus, seed for seed."""

import numpy as np
import pytest

from benchmark import corpus
from lapis_silo_torch.testing import synthetic_database


@pytest.mark.parametrize("n_rows,length,n_partitions,mutations,seed", [
    (4096, 1000, 2, 30, 0),
    (20000, 2000, 3, 30, 123456789012),
    # a partition of 262,144 sequences, as the cells' partitions hold
    (262144, 300, 1, 2, 2**31 + 7),
])
def test_corpus_equals_synthetic_database(n_rows, length, n_partitions,
                                          mutations, seed):
    ours = corpus.build_database(
        corpus.draw(n_rows, length, n_partitions, mutations, seed))
    theirs = synthetic_database(n_rows, length, n_partitions=n_partitions,
                                mutations_per_genome=mutations, seed=seed)
    assert ours.dictionaries["key"].values == theirs.dictionaries["key"].values
    assert (ours.dictionaries["country"].values
            == theirs.dictionaries["country"].values)
    assert (ours.reference_genomes.nucleotide_ids["main"]
            == theirs.reference_genomes.nucleotide_ids["main"]).all()
    for a, b in zip(ours.partitions, theirs.partitions, strict=True):
        assert a.sequence_count == b.sequence_count
        for name in ("key", "country"):
            assert (a.columns[name].ids == b.columns[name].ids).all()
        for name in ("date", "age"):
            assert a.columns[name].values.dtype == b.columns[name].values.dtype
            assert (a.columns[name].values == b.columns[name].values).all()
        bitmaps = a.columns["country"].value_bitmaps
        assert bitmaps.keys() == b.columns["country"].value_bitmaps.keys()
        for vid, words in bitmaps.items():
            assert (words == b.columns["country"].value_bitmaps[vid]).all()
        # the segment as the port reads it, whatever its layout
        sa, sb = a.nuc_sequences["main"], b.nuc_sequences["main"]
        for name in ("sym_ids", "pos_ids", "counts", "majority"):
            assert (getattr(sa, name) == getattr(sb, name)).all(), name
        for sym, pos in zip(sa.sym_ids.tolist(), sa.pos_ids.tolist()):
            assert (sa.plane(sym, pos) == sb.plane(sym, pos)).all()
        for pos in range(0, length, max(1, length // 40)):
            for sym in range(sa.alphabet.count):  # the implicit rows too
                assert (sa.plane(sym, pos) == sb.plane(sym, pos)).all()


def test_corpus_arrays_describe_the_database():
    """The arrays the reference reads hold one entry per mutation, in
    (row, position) order, never the reference's symbol, and by_position
    orders them by (position, symbol, row)."""
    drawn = corpus.draw(5000, 700, 2, 30, 99)
    for part in drawn.partitions:
        flat = part.rows * drawn.length + part.positions
        assert (np.diff(flat) > 0).all()
        assert (part.symbols != drawn.reference[part.positions]).all()
        assert ((part.symbols >= 1) & (part.symbols <= 4)).all()
        order = part.by_position
        key = (part.positions[order] * 5 + part.symbols[order]) * (
            part.n_rows) + part.rows[order]
        assert (np.diff(key) > 0).all()
        assert (np.diff(part.days) >= 0).all()
