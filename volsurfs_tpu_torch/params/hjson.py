"""Minimal hjson-subset parser (no external dependency).

The reference config files (reference config/*.cfg) are hjson: unquoted keys,
``#``/``//`` comments, optional commas, bareword strings. This parser covers
exactly that subset so the reference's config files load unmodified.
"""

from __future__ import annotations


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def error(self, msg):
        line = self.text[: self.pos].count("\n") + 1
        raise ValueError(f"hjson parse error line {line}: {msg}")

    def peek(self):
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def skip_ws(self, skip_newlines=True):
        while self.pos < len(self.text):
            ch = self.text[self.pos]
            if ch == "#" or self.text[self.pos : self.pos + 2] == "//":
                while self.pos < len(self.text) and self.text[self.pos] != "\n":
                    self.pos += 1
            elif self.text[self.pos : self.pos + 2] == "/*":
                end = self.text.find("*/", self.pos)
                self.pos = len(self.text) if end < 0 else end + 2
            elif ch in " \t\r," or (skip_newlines and ch == "\n"):
                self.pos += 1
            else:
                break

    def parse_value(self):
        self.skip_ws()
        ch = self.peek()
        if ch == "{":
            return self.parse_object()
        if ch == "[":
            return self.parse_array()
        if ch in "\"'":
            return self.parse_quoted()
        return self.parse_bareword()

    def parse_object(self):
        assert self.peek() == "{"
        self.pos += 1
        obj = {}
        while True:
            self.skip_ws()
            if self.peek() == "}":
                self.pos += 1
                return obj
            if self.peek() == "":
                self.error("unterminated object")
            key = self.parse_key()
            self.skip_ws()
            if self.peek() != ":":
                self.error(f"expected ':' after key {key!r}")
            self.pos += 1
            obj[key] = self.parse_value()

    def parse_array(self):
        assert self.peek() == "["
        self.pos += 1
        arr = []
        while True:
            self.skip_ws()
            if self.peek() == "]":
                self.pos += 1
                return arr
            if self.peek() == "":
                self.error("unterminated array")
            arr.append(self.parse_value())

    def parse_key(self):
        if self.peek() in "\"'":
            return self.parse_quoted()
        start = self.pos
        while self.pos < len(self.text) and (
            self.text[self.pos].isalnum() or self.text[self.pos] in "_-.$"
        ):
            self.pos += 1
        if self.pos == start:
            self.error("expected key")
        return self.text[start : self.pos]

    def parse_quoted(self):
        quote = self.text[self.pos]
        self.pos += 1
        out = []
        while self.pos < len(self.text):
            ch = self.text[self.pos]
            if ch == "\\":
                self.pos += 1
                esc = self.text[self.pos]
                out.append({"n": "\n", "t": "\t", "r": "\r"}.get(esc, esc))
            elif ch == quote:
                self.pos += 1
                return "".join(out)
            else:
                out.append(ch)
            self.pos += 1
        self.error("unterminated string")

    def parse_bareword(self):
        start = self.pos
        while self.pos < len(self.text) and self.text[self.pos] not in "\n,}]#":
            self.pos += 1
        word = self.text[start : self.pos].strip()
        if word == "":
            self.error("expected value")
        for cast in (int, float):
            try:
                return cast(word)
            except ValueError:
                pass
        if word in ("true", "True"):
            return True
        if word in ("false", "False"):
            return False
        if word in ("null", "None"):
            return None
        return word


def loads(text: str):
    p = _Parser(text)
    p.skip_ws()
    if p.peek() == "{":
        value = p.parse_object()
    else:
        # hjson allows a braceless top-level object
        obj = {}
        while True:
            p.skip_ws()
            if p.peek() == "":
                break
            key = p.parse_key()
            p.skip_ws()
            if p.peek() != ":":
                p.error(f"expected ':' after key {key!r}")
            p.pos += 1
            obj[key] = p.parse_value()
        value = obj
    return value


def load(path: str):
    with open(path) as f:
        return loads(f.read())
