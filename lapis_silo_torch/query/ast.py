"""Filter expression AST: JSON parsing and per-partition compilation to IR.

Parity with reference src/silo/query_engine/filter_expressions/*.cpp —
all 21 expression types, exact validation error messages (the invalid-query
conformance corpus asserts them verbatim), and the same compile-time
semantics (ambiguity modes, IUPAC expansion, null sentinels, the untyped-
column fallbacks to Empty vs. thrown errors).
"""

from __future__ import annotations

import json as _json
from dataclasses import dataclass

import numpy as np

from ..common.dates import string_to_date
from ..common.symbols import AMBIGUITY_NUC_SYMBOLS, AMINO_ACID, NUCLEOTIDE
from . import ir
from .errors import QueryParseError, check_query

# Ambiguity modes (reference filter_expressions/expression.h)
NONE = "NONE"
UPPER_BOUND = "UPPER_BOUND"
LOWER_BOUND = "LOWER_BOUND"


def invert_mode(mode: str) -> str:
    if mode == UPPER_BOUND:
        return LOWER_BOUND
    if mode == LOWER_BOUND:
        return UPPER_BOUND
    return mode


def _uniform(db) -> bool:
    """True while the device engine lowers a query: compilation must then
    produce the SAME IR structure for every partition (no Empty/Full
    shortcuts that depend on per-partition data), so one fused device
    program can be vmapped over the partition axis."""
    return getattr(db, "uniform_compile", False)


def _simplify(db, node):
    return node if _uniform(db) else ir.simplify(node)


def _lower_or(db, children: list[ir.Node]) -> ir.Node:
    """Or lowering incl. the reference's De Morgan rewrite (or.cpp:41-95):
    when any child compiled to a Complement, the union becomes
    NOT(AND(negated children)) — and negation of a single-predicate
    Selection flips its comparator, which differs from a true complement for
    float NaN nulls. The corpus pins the reference behavior, so we replicate
    the rewrite exactly."""
    node = _simplify(db, ir.Or(children))
    if isinstance(node, ir.Or) and any(isinstance(c, ir.Not) for c in node.children):
        return ir.Not(ir.And([c.negate() for c in node.children]))
    return node


def is_unsigned(value) -> bool:
    return isinstance(value, int) and not isinstance(value, bool) and value >= 0


def is_integer(value) -> bool:
    return isinstance(value, int) and not isinstance(value, bool)


def is_float(value) -> bool:
    return isinstance(value, float)


def is_number(value) -> bool:
    return is_integer(value) or is_float(value)


def dump(value) -> str:
    return _json.dumps(value, separators=(",", ":"), ensure_ascii=False)


class Expression:
    def compile(self, db, partition, mode: str) -> ir.Node:
        raise NotImplementedError


@dataclass
class TrueExpr(Expression):
    @classmethod
    def parse(cls, json):
        return cls()

    def compile(self, db, partition, mode):
        return ir.Full()


@dataclass
class FalseExpr(Expression):
    @classmethod
    def parse(cls, json):
        return cls()

    def compile(self, db, partition, mode):
        return ir.Empty()


@dataclass
class AndExpr(Expression):
    children: list[Expression]

    @classmethod
    def parse(cls, json):
        check_query("children" in json, "The field 'children' is required in an And expression")
        check_query(
            isinstance(json["children"], list),
            "The field 'children' in an And expression needs to be an array",
        )
        return cls([parse_expression(c) for c in json["children"]])

    def compile(self, db, partition, mode):
        return _simplify(db, ir.And([c.compile(db, partition, mode) for c in self.children]))


@dataclass
class OrExpr(Expression):
    children: list[Expression]

    @classmethod
    def parse(cls, json):
        check_query("children" in json, "The field 'children' is required in an Or expression")
        check_query(
            isinstance(json["children"], list),
            "The field 'children' in an Or expression needs to be an array",
        )
        return cls([parse_expression(c) for c in json["children"]])

    def compile(self, db, partition, mode):
        return _lower_or(db, [c.compile(db, partition, mode) for c in self.children])


@dataclass
class NotExpr(Expression):
    child: Expression

    @classmethod
    def parse(cls, json):
        check_query("child" in json, "The field 'child' is required in a Not expression")
        return cls(parse_expression(json["child"]))

    def compile(self, db, partition, mode):
        return self.child.compile(db, partition, invert_mode(mode)).negate()


@dataclass
class MaybeExpr(Expression):
    child: Expression

    @classmethod
    def parse(cls, json):
        check_query("child" in json, "The field 'child' is required in a Maybe expression")
        return cls(parse_expression(json["child"]))

    def compile(self, db, partition, mode):
        return self.child.compile(db, partition, UPPER_BOUND)


@dataclass
class ExactExpr(Expression):
    child: Expression

    @classmethod
    def parse(cls, json):
        check_query("child" in json, "The field 'child' is required in a Exact expression")
        return cls(parse_expression(json["child"]))

    def compile(self, db, partition, mode):
        return self.child.compile(db, partition, LOWER_BOUND)


@dataclass
class NOfExpr(Expression):
    children: list[Expression]
    number_of_matchers: int
    match_exactly: bool

    @classmethod
    def parse(cls, json):
        check_query("children" in json, "The field 'children' is required in an N-Of expression")
        check_query(
            isinstance(json["children"], list),
            "The field 'children' in an N-Of expression needs to be an array",
        )
        check_query(
            "numberOfMatchers" in json,
            "The field 'numberOfMatchers' is required in an N-Of expression",
        )
        check_query(
            is_unsigned(json["numberOfMatchers"]),
            "The field 'numberOfMatchers' in an N-Of expression needs to be an unsigned integer",
        )
        check_query(
            "matchExactly" in json, "The field 'matchExactly' is required in an N-Of expression"
        )
        check_query(
            isinstance(json["matchExactly"], bool),
            "The field 'matchExactly' in an N-Of expression needs to be a boolean",
        )
        return cls(
            [parse_expression(c) for c in json["children"]],
            json["numberOfMatchers"],
            json["matchExactly"],
        )

    def compile(self, db, partition, mode):
        return ir.Threshold(
            self.number_of_matchers,
            self.match_exactly,
            [c.compile(db, partition, mode) for c in self.children],
        )


@dataclass
class NucleotideSymbolEquals(Expression):
    sequence_name: str | None
    position: int  # 0-based
    symbol: str | None  # None = '.' = reference symbol

    @classmethod
    def parse(cls, json):
        check_query(
            isinstance(json, dict) and "position" in json,
            "The field 'position' is required in a NucleotideEquals expression",
        )
        check_query(
            is_unsigned(json["position"]) and json["position"] > 0,
            "The field 'position' in a NucleotideEquals expression needs to be an unsigned "
            "integer greater than 0",
        )
        check_query(
            "symbol" in json, "The field 'symbol' is required in a NucleotideEquals expression"
        )
        check_query(
            isinstance(json["symbol"], str),
            "The field 'symbol' in a NucleotideEquals expression needs to be a string",
        )
        sequence_name = json.get("sequenceName")
        symbol = json["symbol"]
        check_query(
            len(symbol) == 1, "The string field 'symbol' must be exactly one character long"
        )
        check_query(
            NUCLEOTIDE.to_id(symbol) is not None or symbol == ".",
            "The string field 'symbol' must be either a valid nucleotide symbol or the '.' "
            "symbol.",
        )
        return cls(sequence_name, json["position"] - 1, None if symbol == "." else symbol)

    def compile(self, db, partition, mode):
        name = (
            self.sequence_name
            if self.sequence_name is not None
            else db.config.default_nucleotide_sequence
        )
        check_query(
            name in db.nuc_sequences,
            f"Database does not contain the nucleotide sequence with name: '{name}'",
        )
        segment = partition.nuc_sequences[name]
        if self.position >= segment.length:
            raise QueryParseError(
                f"NucleotideEquals position is out of bounds '{self.position + 1}' > "
                f"'{segment.length}'"
            )
        if self.symbol is not None:
            symbol = self.symbol
        else:
            symbol = NUCLEOTIDE.to_char(int(segment.reference_ids[self.position]))
        if mode == UPPER_BOUND:
            # IUPAC expansion (reference nucleotide_symbol_equals.cpp:28-76,116-133)
            children = [
                NucleotideSymbolEquals(name, self.position, s)
                for s in AMBIGUITY_NUC_SYMBOLS[symbol]
            ]
            return _lower_or(db, [c.compile(db, partition, NONE) for c in children])
        sym_id = NUCLEOTIDE.to_id(symbol)
        return ir.Plane(
            label=f"nuc:{name}:{self.position + 1}{symbol}",
            static_ref=("nuc", name, sym_id, self.position),
            row=(segment, sym_id, self.position),
        )


@dataclass
class AASymbolEquals(Expression):
    sequence_name: str
    position: int
    symbol: str | None

    @classmethod
    def parse(cls, json):
        check_query(
            "sequenceName" in json and isinstance(json["sequenceName"], str),
            "AminoAcidEquals expression requires the string field sequenceName",
        )
        check_query(
            isinstance(json, dict) and "position" in json,
            "The field 'position' is required in a AminoAcidEquals expression",
        )
        check_query(
            is_unsigned(json["position"]) and json["position"] > 0,
            "The field 'position' in a AminoAcidEquals expression needs to be an unsigned "
            "integer greater than 0",
        )
        check_query(
            "symbol" in json and isinstance(json["symbol"], str),
            "The string field 'symbol' is required in a AminoAcidEquals expression",
        )
        symbol = json["symbol"]
        check_query(
            len(symbol) == 1, "The string field 'symbol' must be exactly one character long"
        )
        check_query(
            AMINO_ACID.to_id(symbol) is not None or symbol == ".",
            "The string field 'symbol' must be either a valid amino acid or the '.' symbol.",
        )
        return cls(json["sequenceName"], json["position"] - 1, None if symbol == "." else symbol)

    def compile(self, db, partition, mode):
        # Reference aa_symbol_equals.cpp ignores the ambiguity mode and uses
        # map::at (missing sequence name -> internal error / HTTP 500).
        segment = partition.aa_sequences[self.sequence_name]
        if self.position >= segment.length:
            raise QueryParseError(
                f"AminoAcidEquals position is out of bounds '{self.position + 1}' > "
                f"'{segment.length}'"
            )
        if self.symbol is not None:
            symbol = self.symbol
        else:
            symbol = AMINO_ACID.to_char(int(segment.reference_ids[self.position]))
        sym_id = AMINO_ACID.to_id(symbol)
        return ir.Plane(
            label=f"aa:{self.sequence_name}:{self.position + 1}{symbol}",
            static_ref=("aa", self.sequence_name, sym_id, self.position),
            row=(segment, sym_id, self.position),
        )


@dataclass
class HasNucleotideMutation(Expression):
    sequence_name: str | None
    position: int

    @classmethod
    def parse(cls, json):
        check_query(
            "position" in json,
            "The field 'position' is required in a HasNucleotideMutation expression",
        )
        check_query(
            is_unsigned(json["position"]),
            "The field 'position' in a HasNucleotideMutation expression needs to be an "
            "unsigned integer",
        )
        return cls(json.get("sequenceName"), json["position"] - 1)

    def compile(self, db, partition, mode):
        name = (
            self.sequence_name
            if self.sequence_name is not None
            else db.config.default_nucleotide_sequence
        )
        check_query(
            name in db.nuc_sequences,
            f"Database does not contain the nucleotide sequence with name: '{name}'",
        )
        if self.position < 0:
            # reference: position 0 underflows uint32 and .at() throws
            # out_of_range -> HTTP 500 (has_mutation.cpp:49)
            raise IndexError("HasNucleotideMutation position underflow")
        ref_symbol = NUCLEOTIDE.to_char(int(db.nuc_sequences[name][self.position]))
        if mode == UPPER_BOUND:
            return (
                NucleotideSymbolEquals(name, self.position, ref_symbol)
                .compile(db, partition, NONE)
                .negate()
            )
        # std::remove-without-erase quirk (has_mutation.cpp:65): the stale
        # trailing element keeps 'T' in the vector, so for ref=T the Or still
        # contains T (the corpus pins reference behavior, bug included).
        symbols = [s for s in ["A", "C", "G", "T"] if s != ref_symbol]
        if ref_symbol in ("A", "C", "G", "T"):
            symbols.append("T")
        children = [
            NucleotideSymbolEquals(name, self.position, s).compile(db, partition, NONE)
            for s in symbols
        ]
        return _lower_or(db, children)


@dataclass
class HasAAMutation(Expression):
    sequence_name: str
    position: int

    @classmethod
    def parse(cls, json):
        check_query(
            "position" in json,
            "The field 'position' is required in a HasAminoAcidMutation expression",
        )
        check_query(
            is_unsigned(json["position"]),
            "The field 'position' in a HasAminoAcidMutation expression needs to be an "
            "unsigned integer",
        )
        check_query(
            "sequenceName" in json and isinstance(json["sequenceName"], str),
            "HasAminoAcidMutation expression requires the string field sequenceName",
        )
        return cls(json["sequenceName"], json["position"] - 1)

    def compile(self, db, partition, mode):
        if self.position < 0:
            raise IndexError("HasAminoAcidMutation position underflow")  # -> 500
        ref_symbol = AMINO_ACID.to_char(int(db.aa_sequences[self.sequence_name][self.position]))
        if mode == UPPER_BOUND:
            return (
                AASymbolEquals(self.sequence_name, self.position, ref_symbol)
                .compile(db, partition, NONE)
                .negate()
            )
        symbols = [
            c
            for c in AMINO_ACID.iteration_chars
            if c != AMINO_ACID.missing_char and c != ref_symbol
        ]
        if ref_symbol == "*":
            # double std::remove-without-erase (has_aa_mutation.cpp:49-52):
            # removing X then STOP leaves a stale '*' in the vector, so for
            # ref=STOP the Or still contains STOP.
            symbols.append("*")
        children = [
            AASymbolEquals(self.sequence_name, self.position, s).compile(db, partition, NONE)
            for s in symbols
        ]
        return _lower_or(db, children)


@dataclass
class DateBetween(Expression):
    column: str
    date_from: int | None
    date_to: int | None

    @classmethod
    def parse(cls, json):
        check_query("column" in json, "The field 'column' is required in a DateBetween expression")
        check_query(
            isinstance(json["column"], str),
            "The field 'column' in a DateBetween expression needs to be a string",
        )
        check_query("from" in json, "The field 'from' is required in DateBetween expression")
        check_query(
            json["from"] is None or (isinstance(json["from"], str) and json["from"] != ""),
            "The field 'from' in a DateBetween expression needs to be a string or null",
        )
        check_query("to" in json, "The field 'to' is required in a DateBetween expression")
        check_query(
            json["to"] is None or (isinstance(json["to"], str) and json["to"] != ""),
            "The field 'to' in a DateBetween expression needs to be a non-empty string or null",
        )
        date_from = string_to_date(json["from"]) if isinstance(json["from"], str) else None
        date_to = string_to_date(json["to"]) if isinstance(json["to"], str) else None
        return cls(json["column"], date_from, date_to)

    def compile(self, db, partition, mode):
        column = partition.columns[self.column]
        if column.kind != "date":
            raise KeyError(self.column)  # map::at semantics -> 500
        values = column.values
        if not column.is_sorted:
            # Unsorted: [from.or(1), to.or(UINT32_MAX)) — upper bound EXCLUSIVE
            # (reference date_between.cpp:52-71).
            return ir.Selection(
                [
                    ir.Predicate(
                        values, ir.HIGHER_OR_EQUALS,
                        np.uint32(self.date_from if self.date_from is not None else 1),
                    ),
                    ir.Predicate(
                        values, ir.LESS,
                        np.uint32(self.date_to if self.date_to is not None else 0xFFFFFFFF),
                    ),
                ]
            )
        # Sorted column: binary-search semantics = [from.or(1), to] INCLUSIVE
        # (reference date_between.cpp:80-100); nulls (0) excluded by from>=1.
        preds = [
            ir.Predicate(
                values, ir.HIGHER_OR_EQUALS,
                np.uint32(self.date_from if self.date_from is not None else 1),
            )
        ]
        if self.date_to is not None:
            preds.append(ir.Predicate(values, ir.LESS_OR_EQUALS, np.uint32(self.date_to)))
        return ir.Selection(preds)


@dataclass
class StringEquals(Expression):
    column: str
    value: str

    @classmethod
    def parse(cls, json):
        check_query(
            "column" in json, "The field 'column' is required in an StringEquals expression"
        )
        check_query(
            isinstance(json["column"], str),
            "The field 'column' in an StringEquals expression needs to be a string",
        )
        check_query(
            "value" in json, "The field 'value' is required in an StringEquals expression"
        )
        check_query(
            isinstance(json["value"], str) or json["value"] is None,
            "The field 'value' in an StringEquals expression needs to be a string or null",
        )
        return cls(json["column"], json["value"] if json["value"] is not None else "")

    def compile(self, db, partition, mode):
        column = partition.columns.get(self.column)
        if column is None:
            return ir.Empty()
        if column.kind == "indexed_string":
            words = column.filter(self.value)
            if words is None or not words.any():
                if _uniform(db):
                    from ..ops import bitset as _bs
                    return ir.Plane(_bs.empty_mask(partition.sequence_count),
                                    label=f"str:{self.column}=∅")
                return ir.Empty()
            return ir.Plane(words, label=f"str:{self.column}={self.value}")
        if column.kind == "string":
            vid = column.dictionary.get(self.value)
            if vid is None:
                return ir.Empty()
            return ir.Selection([ir.Predicate(column.ids, ir.EQUALS, np.int32(vid))])
        return ir.Empty()


@dataclass
class PangoLineageFilter(Expression):
    column: str
    value: str
    include_sublineages: bool

    @classmethod
    def parse(cls, json):
        check_query(
            "column" in json, "The field 'column' is required in a PangoLineage expression"
        )
        check_query(
            isinstance(json["column"], str),
            "The field 'column' in a PangoLineage expression needs to be a string",
        )
        check_query("value" in json, "The field 'value' is required in a PangoLineage expression")
        check_query(
            isinstance(json["value"], str),
            "The field 'value' in a PangoLineage expression needs to be a string",
        )
        check_query(
            "includeSublineages" in json,
            "The field 'includeSublineages' is required in a PangoLineage expression",
        )
        check_query(
            isinstance(json["includeSublineages"], bool),
            "The field 'includeSublineages' in a PangoLineage expression needs to be a boolean",
        )
        return cls(json["column"], json["value"], json["includeSublineages"])

    def compile(self, db, partition, mode):
        column = partition.columns.get(self.column)
        if column is None or column.kind != "indexed_pango_lineage":
            return ir.Empty()
        lineage = self.value.upper()
        words = (
            column.filter_including_sublineages(lineage)
            if self.include_sublineages
            else column.filter(lineage)
        )
        if words is None:
            if _uniform(db):
                from ..ops import bitset as _bs
                return ir.Plane(_bs.empty_mask(partition.sequence_count),
                                label=f"pango:{self.column}=∅")
            return ir.Empty()
        return ir.Plane(words, label=f"pango:{self.column}={lineage}")


@dataclass
class IntEquals(Expression):
    column: str
    value: int

    @classmethod
    def parse(cls, json):
        check_query("column" in json, "The field 'column' is required in an IntEquals expression")
        check_query(
            isinstance(json["column"], str),
            "The field 'column' in an IntEquals expression must be a string",
        )
        check_query("value" in json, "The field 'value' is required in an IntEquals expression")
        check_query(
            is_integer(json["value"]) or json["value"] is None,
            "The field 'value' in an IntEquals expression must be an integer or null",
        )
        value = json["value"] if json["value"] is not None else -(2**31)
        return cls(json["column"], value)

    def compile(self, db, partition, mode):
        column = partition.columns.get(self.column)
        if column is None or column.kind != "int":
            return ir.Empty()
        return ir.Selection([ir.Predicate(column.values, ir.EQUALS, np.int32(self.value))])


@dataclass
class IntBetween(Expression):
    column: str
    value_from: int | None
    value_to: int | None

    @classmethod
    def parse(cls, json):
        check_query("column" in json, "The field 'column' is required in a IntBetween expression")
        check_query(
            isinstance(json["column"], str),
            "The field 'column' in a IntBetween expression must be a string",
        )
        check_query("from" in json, "The field 'from' is required in IntBetween expression")
        check_query(
            json["from"] is None or is_integer(json["from"]),
            "The field 'from' in a IntBetween expression must be an int or null",
        )
        check_query("to" in json, "The field 'to' is required in a IntBetween expression")
        check_query(
            json["to"] is None or is_integer(json["to"]),
            "The field 'to' in a IntBetween expression must be an int or null",
        )
        return cls(json["column"], json["from"], json["to"])

    def compile(self, db, partition, mode):
        column = partition.columns[self.column]
        if column.kind != "int":
            raise KeyError(self.column)  # map::at semantics -> 500
        from_value = self.value_from if self.value_from is not None else -(2**31) + 1
        preds = [ir.Predicate(column.values, ir.HIGHER_OR_EQUALS, np.int32(from_value))]
        if self.value_to is not None:
            preds.append(ir.Predicate(column.values, ir.LESS_OR_EQUALS, np.int32(self.value_to)))
        return ir.Selection(preds)


@dataclass
class FloatEquals(Expression):
    column: str
    value: float

    @classmethod
    def parse(cls, json):
        check_query(
            "column" in json, "The field 'column' is required in an FloatEquals expression"
        )
        check_query(
            isinstance(json["column"], str),
            "The field 'column' in an FloatEquals expression must be a string",
        )
        check_query("value" in json, "The field 'value' is required in an FloatEquals expression")
        check_query(
            is_float(json["value"]) or json["value"] is None,
            "The field 'value' in an FloatEquals expression must be a float",
        )
        value = json["value"] if json["value"] is not None else float("nan")
        return cls(json["column"], value)

    def compile(self, db, partition, mode):
        column = partition.columns.get(self.column)
        if column is None or column.kind != "float":
            return ir.Empty()
        return ir.Selection([ir.Predicate(column.values, ir.EQUALS, np.float64(self.value))])


@dataclass
class FloatBetween(Expression):
    column: str
    value_from: float | None
    value_to: float | None

    @classmethod
    def parse(cls, json):
        check_query(
            "column" in json, "The field 'column' is required in a FloatBetween expression"
        )
        check_query(
            isinstance(json["column"], str),
            "The field 'column' in a FloatBetween expression must be a string",
        )
        check_query("from" in json, "The field 'from' is required in FloatBetween expression")
        check_query(
            json["from"] is None or is_float(json["from"]),
            "The field 'from' in a FloatBetween expression must be a float or null",
        )
        check_query("to" in json, "The field 'to' is required in a FloatBetween expression")
        check_query(
            json["to"] is None or is_float(json["to"]),
            "The field 'to' in a FloatBetween expression must be a float or null",
        )
        return cls(json["column"], json["from"], json["to"])

    def compile(self, db, partition, mode):
        check_query(
            self.column in partition.columns
            and partition.columns[self.column].kind == "float",
            f"The database does not contain the float column '{self.column}'",
        )
        column = partition.columns[self.column]
        preds = []
        if self.value_from is not None:
            preds.append(
                ir.Predicate(column.values, ir.HIGHER_OR_EQUALS, np.float64(self.value_from))
            )
        if self.value_to is not None:
            preds.append(ir.Predicate(column.values, ir.LESS, np.float64(self.value_to)))
        if not preds:
            # NOT_EQUALS NaN: true for every row incl. nulls (IEEE semantics,
            # reference float_between.cpp:57-63)
            preds.append(ir.Predicate(column.values, ir.NOT_EQUALS, np.float64("nan")))
        return ir.Selection(preds)


@dataclass
class InsertionContains(Expression):
    alphabet_name: str  # "nuc" | "aa"
    column_names: list[str]
    sequence_name: str | None
    position: int
    value: str

    @classmethod
    def parse_typed(cls, json, alphabet):
        expr_name = (
            "InsertionContains" if alphabet is NUCLEOTIDE else "AminoAcidInsertionContains"
        )
        check_query(
            "column" not in json
            or isinstance(json["column"], str)
            or isinstance(json["column"], list),
            "The InsertionsContains filter can have the field column of type string or an "
            "array of strings, but no other type",
        )
        column_names = []
        if "column" in json and isinstance(json["column"], list):
            for child in json["column"]:
                check_query(
                    isinstance(child, str),
                    "The field column of the InsertionsContains filter must have type string "
                    "or an array, if present. Found:" + dump(child),
                )
                column_names.append(child)
        elif "column" in json and isinstance(json["column"], str):
            column_names.append(json["column"])
        check_query(
            "position" in json,
            "The field 'position' is required in an InsertionContains expression",
        )
        check_query(
            is_unsigned(json["position"]) and json["position"] > 0,
            "The field 'position' in an InsertionContains expression needs to be a positive "
            "number (> 0)",
        )
        check_query(
            "sequenceName" not in json or isinstance(json["sequenceName"], str),
            "The optional field 'sequenceName' in an InsertionContains expression needs to "
            "be a string",
        )
        check_query(
            "value" in json, "The field 'value' is required in an InsertionContains expression"
        )
        check_query(
            isinstance(json["value"], str),
            "The field 'value' in an InsertionContains expression needs to be a string",
        )
        value = json["value"]
        check_query(
            value != "",
            "The field 'value' in an InsertionContains expression must not be an empty string",
        )
        check_query(
            _valid_insertion_pattern(value, alphabet),
            "The field 'value' in the InsertionContains expression does not contain a valid "
            f'regex pattern: "{value}". It must only consist of {alphabet.name_lower} '
            "symbols and the regex symbol '.*'.",
        )
        return cls(
            "nuc" if alphabet is NUCLEOTIDE else "aa",
            column_names,
            json.get("sequenceName"),
            json["position"],
            value,
        )

    @property
    def alphabet(self):
        return NUCLEOTIDE if self.alphabet_name == "nuc" else AMINO_ACID

    def compile(self, db, partition, mode):
        kind = "nuc_insertion" if self.alphabet_name == "nuc" else "aa_insertion"
        insertion_columns = {
            name: col for name, col in sorted(partition.columns.items()) if col.kind == kind
        }
        for column_name in self.column_names:
            check_query(
                column_name in insertion_columns,
                f"The insertion column '{column_name}' does not exist.",
            )
        if not insertion_columns:
            return ir.Empty()
        if self.sequence_name is not None:
            sequence_name = self.sequence_name
        else:
            default = db.default_sequence_name(self.alphabet)
            check_query(
                default is not None,
                f"The database has no default {self.alphabet.name_lower} sequence name",
            )
            sequence_name = default
        children = []
        for column_name, column in insertion_columns.items():
            if self.column_names and column_name not in self.column_names:
                continue
            if sequence_name in column.insertion_indexes or _uniform(db):
                words = column.search(sequence_name, self.position, self.value)
                children.append(
                    ir.Plane(words, label=f"ins:{column_name}:{self.position}:{self.value}")
                )
        if not children:
            return ir.Empty()
        if len(children) == 1:
            return children[0]
        return ir.Or(children)


def _valid_insertion_pattern(value: str, alphabet) -> bool:
    import re

    chars = "".join(alphabet.iteration_chars)
    pattern = re.compile(r"^([" + re.escape(chars) + r"]|\.\*)*$")
    return pattern.search(value) is not None


_EXPRESSION_TYPES = {
    "True": TrueExpr.parse,
    "False": FalseExpr.parse,
    "And": AndExpr.parse,
    "Or": OrExpr.parse,
    "N-Of": NOfExpr.parse,
    "Not": NotExpr.parse,
    "DateBetween": DateBetween.parse,
    "NucleotideEquals": NucleotideSymbolEquals.parse,
    "HasNucleotideMutation": HasNucleotideMutation.parse,
    "AminoAcidEquals": AASymbolEquals.parse,
    "HasAminoAcidMutation": HasAAMutation.parse,
    "PangoLineage": PangoLineageFilter.parse,
    "StringEquals": StringEquals.parse,
    "IntEquals": IntEquals.parse,
    "IntBetween": IntBetween.parse,
    "FloatEquals": FloatEquals.parse,
    "FloatBetween": FloatBetween.parse,
    "Maybe": MaybeExpr.parse,
    "Exact": ExactExpr.parse,
    "InsertionContains": lambda json: InsertionContains.parse_typed(json, NUCLEOTIDE),
    "AminoAcidInsertionContains": lambda json: InsertionContains.parse_typed(json, AMINO_ACID),
}


# Types whose uniform-mode IR is the same in every partition apart from
# plane words: the leaves read only the partition's segment length and
# reference (one per database) and yield Full, Empty or static-bank Planes;
# the inner nodes only combine their children's IR. Every other type reads
# per-partition columns or insertion indexes.
_PARTITION_FREE_LEAVES = (TrueExpr, FalseExpr, NucleotideSymbolEquals,
                          AASymbolEquals, HasNucleotideMutation, HasAAMutation)
_PARTITION_FREE_LISTS = (AndExpr, OrExpr, NOfExpr)
_PARTITION_FREE_WRAPPERS = (NotExpr, MaybeExpr, ExactExpr)


def partition_free(expr: Expression) -> bool:
    """True when `expr` is built from partition-free types only: its uniform
    compile in one partition, words aside, is its compile in every one."""
    kind = type(expr)
    if kind in _PARTITION_FREE_LISTS:
        return all(partition_free(child) for child in expr.children)
    if kind in _PARTITION_FREE_WRAPPERS:
        return partition_free(expr.child)
    return kind in _PARTITION_FREE_LEAVES


def parse_expression(json) -> Expression:
    check_query(
        isinstance(json, dict) and "type" in json,
        "The field 'type' is required in any filter expression",
    )
    check_query(
        isinstance(json["type"], str),
        "The field 'type' in all filter expressions needs to be a string, but is: "
        + dump(json["type"]),
    )
    expression_type = json["type"]
    parser = _EXPRESSION_TYPES.get(expression_type)
    if parser is None:
        raise QueryParseError(f"Unknown object filter type '{expression_type}'")
    return parser(json)
