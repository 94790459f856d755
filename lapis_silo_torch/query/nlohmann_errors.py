"""Replica of nlohmann::json's parse-error messages.

The reference parses query JSON with nlohmann::json and wraps parse failures
as `"The query was not a valid JSON: " + ex.what()` (ref:
src/silo/query_engine/query.cpp:24-26); the e2e protocol suite pins the full
nlohmann message text (ref: endToEndTests/test/query.test.js:67-80, e.g.
"[json.exception.parse_error.101] parse error at line 1, column 4: syntax
error while parsing object key - invalid literal; last read: '{ no';
expected string literal").

This module re-implements nlohmann 3.11's lexer/parser *error production*
(single_include/nlohmann/json.hpp: detail::lexer scan*/get/unget/
get_token_string, detail::parser::sax_parse_internal/exception_message,
detail::parse_error::create). It only ever runs on the error path — valid
documents are parsed by Python's json module — so clarity beats speed.

Byte positions: nlohmann counts BYTES (line = lines_read + 1, column =
chars_read_current_line); the input is therefore processed as UTF-8 bytes.
"""

from __future__ import annotations

EOF = -1

# token kinds (nlohmann detail::lexer_base::token_type)
(UNINITIALIZED, LITERAL_TRUE, LITERAL_FALSE, LITERAL_NULL, VALUE_STRING,
 VALUE_NUMBER, BEGIN_ARRAY, BEGIN_OBJECT, END_ARRAY, END_OBJECT,
 NAME_SEPARATOR, VALUE_SEPARATOR, PARSE_ERROR, END_OF_INPUT,
 LITERAL_OR_VALUE) = range(15)

_TOKEN_NAMES = {
    UNINITIALIZED: "uninitialized",
    LITERAL_TRUE: "true literal",
    LITERAL_FALSE: "false literal",
    LITERAL_NULL: "null literal",
    VALUE_STRING: "string literal",
    VALUE_NUMBER: "number literal",
    BEGIN_ARRAY: "'['",
    BEGIN_OBJECT: "'{'",
    END_ARRAY: "']'",
    END_OBJECT: "'}'",
    NAME_SEPARATOR: "':'",
    VALUE_SEPARATOR: "','",
    PARSE_ERROR: "<parse error>",
    END_OF_INPUT: "end of input",
    LITERAL_OR_VALUE: "'[', '{', or a literal",
}

_CONTROL_NAMES = [
    "NUL", "SOH", "STX", "ETX", "EOT", "ENQ", "ACK", "BEL", "BS", "HT",
    "LF", "VT", "FF", "CR", "SO", "SI", "DLE", "DC1", "DC2", "DC3", "DC4",
    "NAK", "SYN", "ETB", "CAN", "EM", "SUB", "ESC", "FS", "GS", "RS", "US",
]


class _Lexer:
    """nlohmann detail::lexer with only the pieces error text depends on."""

    def __init__(self, data: bytes):
        self.data = data
        self.idx = 0  # next byte to read
        self.current = UNINITIALIZED  # last byte read (int) or EOF
        self.next_unget = False
        self.chars_read_total = 0
        self.chars_read_current_line = 0
        self.lines_read = 0
        self.token_string = bytearray()
        self.error_message = ""

    # -- character stream (lexer::get / unget) ---------------------------

    def get(self) -> int:
        self.chars_read_total += 1
        self.chars_read_current_line += 1
        if self.next_unget:
            self.next_unget = False
        else:
            if self.idx < len(self.data):
                self.current = self.data[self.idx]
                self.idx += 1
            else:
                self.current = EOF
        if self.current != EOF:
            self.token_string.append(self.current)
        if self.current == 0x0A:  # '\n'
            self.lines_read += 1
            self.chars_read_current_line = 0
        return self.current

    def unget(self):
        self.next_unget = True
        self.chars_read_total -= 1
        if self.chars_read_current_line == 0:
            if self.lines_read > 0:
                self.lines_read -= 1
        else:
            self.chars_read_current_line -= 1
        if self.current != EOF:
            self.token_string.pop()

    def _reset(self):
        # lexer::reset — clears the raw-token buffer, keeps current char
        self.token_string.clear()
        if self.current != EOF:
            self.token_string.append(self.current)

    def get_token_string(self) -> str:
        # nlohmann escapes control bytes as <U+XXXX> and emits all other
        # bytes raw; raw non-UTF-8 bytes become U+FFFD here (a Python str
        # can't carry them, and the reference can't serialize its own error
        # response for such inputs — nlohmann dump() throws on them)
        out = bytearray()
        for byte in self.token_string:
            if byte <= 0x1F:
                out += f"<U+{byte:04X}>".encode()
            else:
                out.append(byte)
        return out.decode("utf-8", "replace")

    def position_string(self) -> str:
        return (f" at line {self.lines_read + 1},"
                f" column {self.chars_read_current_line}")

    # -- scanning ---------------------------------------------------------

    def scan(self) -> int:
        if self.chars_read_total == 0 and not self._skip_bom():
            self.error_message = "invalid BOM; must be 0xEF 0xBB 0xBF if given"
            return PARSE_ERROR
        # read next character and ignore whitespace
        while True:
            self.get()
            if self.current not in (0x20, 0x09, 0x0A, 0x0D):
                break
        c = self.current
        if c == ord("["):
            return BEGIN_ARRAY
        if c == ord("]"):
            return END_ARRAY
        if c == ord("{"):
            return BEGIN_OBJECT
        if c == ord("}"):
            return END_OBJECT
        if c == ord(":"):
            return NAME_SEPARATOR
        if c == ord(","):
            return VALUE_SEPARATOR
        if c == ord("t"):
            return self._scan_literal(b"true", LITERAL_TRUE)
        if c == ord("f"):
            return self._scan_literal(b"false", LITERAL_FALSE)
        if c == ord("n"):
            return self._scan_literal(b"null", LITERAL_NULL)
        if c == ord('"'):
            return self._scan_string()
        if c == ord("-") or ord("0") <= c <= ord("9"):
            return self._scan_number()
        if c == EOF or c == 0x00:
            # nlohmann: the null byte reads as end of input (needed when
            # parsing from string literals)
            return END_OF_INPUT
        self.error_message = "invalid literal"
        return PARSE_ERROR

    def _skip_bom(self) -> bool:
        if self.get() == 0xEF:
            return self.get() == 0xBB and self.get() == 0xBF
        self.unget()
        return True

    def _scan_literal(self, literal: bytes, token: int) -> int:
        for expected in literal[1:]:
            if self.get() != expected:
                self.error_message = "invalid literal"
                return PARSE_ERROR
        return token

    def _in_range(self, lo: int, hi: int) -> bool:
        """lexer::next_byte_in_range: consume one byte, check range."""
        return lo <= self.get() <= hi

    def _scan_string(self) -> int:  # noqa: C901 — mirrors nlohmann's switch
        self._reset()
        while True:
            c = self.get()
            if c == EOF:
                self.error_message = "invalid string: missing closing quote"
                return PARSE_ERROR
            if c == ord('"'):
                return VALUE_STRING
            if c == ord("\\"):
                e = self.get()
                if e in (ord('"'), ord("\\"), ord("/"), ord("b"), ord("f"),
                         ord("n"), ord("r"), ord("t")):
                    continue
                if e == ord("u"):
                    cp1 = self._scan_codepoint()
                    if cp1 is None:
                        return PARSE_ERROR
                    if 0xD800 <= cp1 <= 0xDBFF:  # high surrogate
                        if self.get() != ord("\\") or self.get() != ord("u"):
                            self.error_message = (
                                "invalid string: surrogate U+D800..U+DBFF"
                                " must be followed by U+DC00..U+DFFF")
                            return PARSE_ERROR
                        cp2 = self._scan_codepoint()
                        if cp2 is None:
                            return PARSE_ERROR
                        if not 0xDC00 <= cp2 <= 0xDFFF:
                            self.error_message = (
                                "invalid string: surrogate U+D800..U+DBFF"
                                " must be followed by U+DC00..U+DFFF")
                            return PARSE_ERROR
                    elif 0xDC00 <= cp1 <= 0xDFFF:  # lone low surrogate
                        self.error_message = (
                            "invalid string: surrogate U+DC00..U+DFFF"
                            " must follow U+D800..U+DBFF")
                        return PARSE_ERROR
                    continue
                self.error_message = (
                    "invalid string: forbidden character after backslash")
                return PARSE_ERROR
            if c <= 0x1F:
                name = _CONTROL_NAMES[c]
                # control characters with a short escape also suggest it
                short = {0x08: " or \\b", 0x09: " or \\t", 0x0A: " or \\n",
                         0x0C: " or \\f", 0x0D: " or \\r"}.get(c, "")
                self.error_message = (
                    f"invalid string: control character U+{c:04X} ({name})"
                    f" must be escaped to \\u{c:04X}{short}")
                return PARSE_ERROR
            # UTF-8 multi-byte validation (nlohmann's byte-class cases)
            if c <= 0x7F:
                continue
            if 0xC2 <= c <= 0xDF:
                ok = self._in_range(0x80, 0xBF)
            elif c == 0xE0:
                ok = self._in_range(0xA0, 0xBF) and self._in_range(0x80, 0xBF)
            elif (0xE1 <= c <= 0xEC) or c in (0xEE, 0xEF):
                ok = self._in_range(0x80, 0xBF) and self._in_range(0x80, 0xBF)
            elif c == 0xED:
                ok = self._in_range(0x80, 0x9F) and self._in_range(0x80, 0xBF)
            elif c == 0xF0:
                ok = (self._in_range(0x90, 0xBF) and self._in_range(0x80, 0xBF)
                      and self._in_range(0x80, 0xBF))
            elif 0xF1 <= c <= 0xF3:
                ok = (self._in_range(0x80, 0xBF) and self._in_range(0x80, 0xBF)
                      and self._in_range(0x80, 0xBF))
            elif c == 0xF4:
                ok = (self._in_range(0x80, 0x8F) and self._in_range(0x80, 0xBF)
                      and self._in_range(0x80, 0xBF))
            else:
                ok = False
            if not ok:
                self.error_message = "invalid string: ill-formed UTF-8 byte"
                return PARSE_ERROR

    def _scan_codepoint(self) -> int | None:
        """Four hex digits after \\u (lexer's codepoint loop)."""
        value = 0
        for _ in range(4):
            h = self.get()
            if ord("0") <= h <= ord("9"):
                value = value * 16 + (h - ord("0"))
            elif ord("a") <= h <= ord("f"):
                value = value * 16 + (h - ord("a") + 10)
            elif ord("A") <= h <= ord("F"):
                value = value * 16 + (h - ord("A") + 10)
            else:
                self.error_message = (
                    "invalid string: '\\u' must be followed by 4 hex digits")
                return None
        return value

    def _scan_number(self) -> int:
        """Number DFA; only the error strings and token_string matter."""
        self._reset()
        c = self.current

        def is_digit(ch):
            return ord("0") <= ch <= ord("9")

        def nxt():
            return self.get()

        if c == ord("-"):
            c = nxt()
            if c == ord("0"):
                state = "zero"
            elif is_digit(c):
                state = "any1"
            else:
                self.error_message = "invalid number; expected digit after '-'"
                return PARSE_ERROR
        elif c == ord("0"):
            state = "zero"
        else:
            state = "any1"

        while True:
            if state in ("zero", "any1"):
                if state == "any1":
                    c = nxt()
                    while is_digit(c):
                        c = nxt()
                else:
                    c = nxt()
                if c == ord("."):
                    c = nxt()
                    if not is_digit(c):
                        self.error_message = (
                            "invalid number; expected digit after '.'")
                        return PARSE_ERROR
                    state = "decimal2"
                elif c in (ord("e"), ord("E")):
                    state = "exponent"
                else:
                    self.unget()
                    return VALUE_NUMBER
            elif state == "decimal2":
                c = nxt()
                while is_digit(c):
                    c = nxt()
                if c in (ord("e"), ord("E")):
                    state = "exponent"
                else:
                    self.unget()
                    return VALUE_NUMBER
            elif state == "exponent":
                c = nxt()
                if c in (ord("+"), ord("-")):
                    c = nxt()
                    if not is_digit(c):
                        self.error_message = (
                            "invalid number; expected digit after exponent sign")
                        return PARSE_ERROR
                elif not is_digit(c):
                    self.error_message = (
                        "invalid number; expected '+', '-', or digit after exponent")
                    return PARSE_ERROR
                c = nxt()
                while is_digit(c):
                    c = nxt()
                self.unget()
                return VALUE_NUMBER


class _ParseError(Exception):
    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


class _Parser:
    """nlohmann detail::parser::sax_parse_internal, error paths only."""

    def __init__(self, data: bytes):
        self.lexer = _Lexer(data)
        self.last_token = UNINITIALIZED

    def get_token(self) -> int:
        self.last_token = self.lexer.scan()
        return self.last_token

    def _error(self, expected: int, context: str):
        msg = "syntax error "
        if context:
            msg += f"while parsing {context} "
        msg += "- "
        if self.last_token == PARSE_ERROR:
            msg += (f"{self.lexer.error_message}; last read:"
                    f" '{self.lexer.get_token_string()}'")
        else:
            msg += f"unexpected {_TOKEN_NAMES[self.last_token]}"
        if expected != UNINITIALIZED:
            msg += f"; expected {_TOKEN_NAMES[expected]}"
        raise _ParseError(
            "[json.exception.parse_error.101] parse error"
            f"{self.lexer.position_string()}: {msg}")

    def parse(self):
        self.get_token()
        self._parse_value()
        if self.get_token() != END_OF_INPUT:
            self._error(END_OF_INPUT, "value")

    def _parse_value(self):
        # recursive formulation of nlohmann's state machine — same token
        # sequence and error productions, recursion depth bounded by the
        # document (error-path only, never hot)
        t = self.last_token
        if t == BEGIN_OBJECT:
            if self.get_token() == END_OBJECT:
                return
            while True:
                if self.last_token != VALUE_STRING:
                    self._error(VALUE_STRING, "object key")
                if self.get_token() != NAME_SEPARATOR:
                    self._error(NAME_SEPARATOR, "object separator")
                self.get_token()
                self._parse_value()
                if self.get_token() == VALUE_SEPARATOR:
                    self.get_token()
                    continue
                if self.last_token == END_OBJECT:
                    return
                self._error(END_OBJECT, "object")
        elif t == BEGIN_ARRAY:
            if self.get_token() == END_ARRAY:
                return
            while True:
                self._parse_value()
                if self.get_token() == VALUE_SEPARATOR:
                    self.get_token()
                    continue
                if self.last_token == END_ARRAY:
                    return
                self._error(END_ARRAY, "array")
        elif t in (LITERAL_TRUE, LITERAL_FALSE, LITERAL_NULL, VALUE_STRING,
                   VALUE_NUMBER):
            return
        elif t == PARSE_ERROR:
            self._error(UNINITIALIZED, "value")
        else:
            if (t == END_OF_INPUT
                    and self.lexer.chars_read_total == 1):
                # nlohmann's dedicated empty-input diagnostic
                raise _ParseError(
                    "[json.exception.parse_error.101] parse error"
                    f"{self.lexer.position_string()}: attempting to parse an"
                    " empty input; check that your input string or stream"
                    " contains the expected JSON")
            # unexpected structural token / end of input at value position
            self._error(LITERAL_OR_VALUE, "value")


def parse_error_message(document: str | bytes) -> str | None:
    """The nlohmann ex.what() string for an invalid JSON document, or None
    if nlohmann would accept it."""
    data = document.encode("utf-8", "surrogateescape") if isinstance(
        document, str) else bytes(document)
    try:
        _Parser(data).parse()
    except _ParseError as ex:
        return ex.message
    return None
