"""reference_genomes.json loader.

Parity with reference src/silo/storage/reference_genomes.cpp: the file holds
``{"nucleotideSequences": [{"name", "sequence"}], "genes": [...]}`` and every
sequence is validated against its alphabet.
"""

from __future__ import annotations

import json

import numpy as np

from ..common.symbols import AMINO_ACID, NUCLEOTIDE


class ReferenceGenomes:
    def __init__(self, nucleotide_sequences: dict[str, str], genes: dict[str, str]):
        self.raw_nucleotide_sequences = nucleotide_sequences
        self.raw_aa_sequences = genes
        self.nucleotide_ids: dict[str, np.ndarray] = {
            name: NUCLEOTIDE.string_to_ids(seq) for name, seq in nucleotide_sequences.items()
        }
        self.aa_ids: dict[str, np.ndarray] = {
            name: AMINO_ACID.string_to_ids(seq) for name, seq in genes.items()
        }

    @classmethod
    def read_from_file(cls, path) -> "ReferenceGenomes":
        with open(path) as f:
            data = json.load(f)
        nucs = {entry["name"]: entry["sequence"] for entry in data["nucleotideSequences"]}
        genes = {entry["name"]: entry["sequence"] for entry in data["genes"]}
        return cls(nucs, genes)

    def to_dict(self) -> dict:
        return {
            "nucleotideSequences": [
                {"name": n, "sequence": s} for n, s in self.raw_nucleotide_sequences.items()
            ],
            "genes": [{"name": n, "sequence": s} for n, s in self.raw_aa_sequences.items()],
        }
