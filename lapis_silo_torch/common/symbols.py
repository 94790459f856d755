"""Symbol alphabets for nucleotides (IUPAC) and amino acids.

Behavioral parity with the reference implementation's alphabets
(reference: include/silo/common/nucleotide_symbols.h,
include/silo/common/aa_symbols.h and the ambiguity expansion table in
src/silo/query_engine/filter_expressions/nucleotide_symbol_equals.cpp:28).

The integer value of each symbol defines its *plane index* in the dense
bitplane tensors, so the order here is load-bearing for the whole engine.
"""

from __future__ import annotations

import numpy as np


class Alphabet:
    """A fixed symbol alphabet: chars, enum order, and helper tables."""

    def __init__(
        self,
        name: str,
        short_name: str,
        chars: list[str],
        char_aliases: dict[str, str],
        valid_mutation_chars: list[str],
        missing_char: str,
        iteration_order: list[str] | None = None,
    ):
        self.name = name  # e.g. "Nucleotide"
        self.name_lower = name.lower()
        self.short_name = short_name
        self.chars = chars  # index = enum value = plane index
        self.count = len(chars)
        self.char_to_id: dict[str, int] = {c: i for i, c in enumerate(chars)}
        for alias, target in char_aliases.items():
            self.char_to_id[alias] = self.char_to_id[target]
        self.valid_mutation_chars = valid_mutation_chars
        self.valid_mutation_ids = [self.char_to_id[c] for c in valid_mutation_chars]
        self.missing_char = missing_char
        self.missing_id = self.char_to_id[missing_char]
        # Order in which symbols are iterated for output (SYMBOLS array in the
        # reference, which differs from enum order for amino acids).
        self.iteration_chars = iteration_order if iteration_order is not None else list(chars)
        self.iteration_ids = [self.char_to_id[c] for c in self.iteration_chars]
        # char byte -> symbol id lookup table (255 = illegal char)
        self._lut = np.full(256, 255, dtype=np.uint8)
        for char, sid in self.char_to_id.items():
            self._lut[ord(char)] = sid

    def to_char(self, symbol_id: int) -> str:
        return self.chars[symbol_id]

    def to_id(self, char: str) -> int | None:
        return self.char_to_id.get(char)

    def string_to_ids(self, sequence: str) -> np.ndarray:
        """Vectorized char->symbol-id conversion; raises on illegal chars."""
        raw = np.frombuffer(sequence.encode("ascii"), dtype=np.uint8)
        ids = self._lut[raw]
        if (ids == 255).any():
            bad = chr(int(raw[np.argmax(ids == 255)]))
            raise ValueError(
                f"Illegal character '{bad}' in {self.name_lower} sequence"
            )
        return ids

    def ids_into(self, raw: bytes, out: np.ndarray) -> None:
        """char->symbol-id conversion of `raw` bytes into the preallocated
        uint8 row `out` (same length) — single pass through the native
        kernel when available, matching string_to_ids error semantics.
        Called once per genome, so the native fn + LUT address are cached
        on first use (get_lib takes a lock; attribute chains add up)."""
        fn = self.__dict__.get("_ids_fn", 0)
        if fn == 0:
            from .. import native

            lib = native.get_lib()
            fn = lib.silo_chars_to_ids if lib is not None else None
            self._ids_fn = fn
            self._lut_addr = self._lut.ctypes.data
        if fn is not None:
            bad = fn(raw, len(raw), self._lut_addr, out.ctypes.data)
            if bad >= 0:
                raise ValueError(
                    f"Illegal character '{chr(bad)}' in {self.name_lower} sequence"
                )
            return
        arr = np.frombuffer(raw, dtype=np.uint8)
        ids = self._lut[arr]
        if (ids == 255).any():
            bad_char = chr(int(arr[np.argmax(ids == 255)]))
            raise ValueError(
                f"Illegal character '{bad_char}' in {self.name_lower} sequence"
            )
        out[:] = ids

    def find_illegal_char(self, sequence: str) -> str | None:
        raw = np.frombuffer(sequence.encode("ascii"), dtype=np.uint8)
        ids = self._lut[raw]
        if (ids == 255).any():
            return chr(int(raw[np.argmax(ids == 255)]))
        return None


# Nucleotide alphabet: enum order GAP A C G T R Y S W K M B D H V N
# ('.' and '-' both map to GAP; 'U' maps to T).
NUCLEOTIDE = Alphabet(
    name="Nucleotide",
    short_name="NUC",
    chars=["-", "A", "C", "G", "T", "R", "Y", "S", "W", "K", "M", "B", "D", "H", "V", "N"],
    char_aliases={".": "-", "U": "T"},
    valid_mutation_chars=["-", "A", "C", "G", "T"],
    missing_char="N",
)

# Amino-acid alphabet: enum order GAP A C D E F G H I K L M N P Q R S T V W Y B Z STOP X
# Iteration (SYMBOLS array) order puts X before STOP ('*').
AMINO_ACID = Alphabet(
    name="Amino Acid",
    short_name="AA",
    chars=[
        "-", "A", "C", "D", "E", "F", "G", "H", "I", "K", "L", "M", "N",
        "P", "Q", "R", "S", "T", "V", "W", "Y", "B", "Z", "*", "X",
    ],
    char_aliases={".": "-"},
    valid_mutation_chars=[
        "-", "A", "C", "D", "E", "F", "G", "H", "I", "K", "L", "M", "N",
        "P", "Q", "R", "S", "T", "V", "W", "Y", "*",
    ],
    missing_char="X",
    iteration_order=[
        "-", "A", "C", "D", "E", "F", "G", "H", "I", "K", "L", "M", "N",
        "P", "Q", "R", "S", "T", "V", "W", "Y", "B", "Z", "X", "*",
    ],
)

# For each nucleotide symbol, the set of symbols that *could* represent it
# under IUPAC ambiguity (used by the Maybe/UPPER_BOUND mode). Mirrors the
# reference's AMBIGUITY_NUC_SYMBOLS table.
AMBIGUITY_NUC_SYMBOLS: dict[str, list[str]] = {
    "-": ["-"],
    "A": ["A", "R", "M", "W", "D", "H", "V", "N"],
    "C": ["C", "Y", "M", "S", "B", "H", "V", "N"],
    "G": ["G", "R", "K", "S", "B", "D", "V", "N"],
    "T": ["T", "Y", "K", "W", "B", "D", "H", "N"],
    "R": ["R"],
    "Y": ["Y"],
    "S": ["S"],
    "W": ["W"],
    "K": ["K"],
    "M": ["M"],
    "B": ["B"],
    "D": ["D"],
    "H": ["H"],
    "V": ["V"],
    "N": ["N"],
}
