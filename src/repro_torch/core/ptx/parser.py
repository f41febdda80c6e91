"""Mirrors ``src/repro/core/ptx/parser.py`` (only the imports differ).

Parser for the PTX subset (text -> :mod:`repro.core.ptx.ir`)."""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from .ir import Imm, Instr, Kernel, Label, LabelRef, MemRef, Module, Reg, TYPE_WIDTH

_COMMENT_BLOCK = re.compile(r"/\*.*?\*/", re.S)
_COMMENT_LINE = re.compile(r"//[^\n]*")
_ENTRY = re.compile(r"\.(?:visible\s+)?(?:\.weak\s+)?entry\s+([A-Za-z_$][\w$]*)\s*\(")
_PARAM = re.compile(r"\.param\s+\.(\w+)(?:\s+\.ptr[\w\s.]*)?\s+([\w$]+)(?:\[\d+\])?")
_REG_DECL = re.compile(r"\.reg\s+\.(\w+)\s+%([A-Za-z_]+)<(\d+)>\s*;")
_REG_DECL_SINGLE = re.compile(r"\.reg\s+\.(\w+)\s+(%[\w.]+)\s*;")
_LABEL = re.compile(r"^([$\w]+):\s*$")
_VERSION = re.compile(r"\.version\s+([\d.]+)")
_TARGET = re.compile(r"\.target\s+([\w ,]+)")
_ADDR_SIZE = re.compile(r"\.address_size\s+(\d+)")
_FLOAT_IMM = re.compile(r"^0[fF]([0-9A-Fa-f]{8})$")
_DOUBLE_IMM = re.compile(r"^0[dD]([0-9A-Fa-f]{16})$")


def _strip_comments(text: str) -> str:
    text = _COMMENT_BLOCK.sub(" ", text)
    text = _COMMENT_LINE.sub(" ", text)
    return text


def _parse_operand(tok: str) -> object:
    tok = tok.strip()
    if tok.startswith("["):
        inner = tok[1:-1].strip()
        if "+" in inner:
            base, off = inner.split("+", 1)
            return MemRef(base.strip(), int(off.strip(), 0))
        if "-" in inner[1:]:
            base, off = inner[0] + inner[1:].split("-", 1)[0], inner[1:].split("-", 1)[1]
            return MemRef(base.strip(), -int(off.strip(), 0))
        return MemRef(inner)
    m = _FLOAT_IMM.match(tok)
    if m:
        return Imm(int(m.group(1), 16), is_float=True, width=32)
    m = _DOUBLE_IMM.match(tok)
    if m:
        return Imm(int(m.group(1), 16), is_float=True, width=64)
    if re.match(r"^[+-]?(0[xX][0-9A-Fa-f]+|\d+)$", tok):
        return Imm(int(tok, 0), hex=tok[:2].lower() == "0x")
    if tok.startswith("$") or (not tok.startswith("%") and tok.isupper() and tok not in ("WARP_SZ",)):
        return LabelRef(tok)
    return Reg(tok)


def _split_operands(rest: str) -> List[str]:
    """Split an operand list on top-level commas (brackets protected)."""
    out, depth, cur = [], 0, []
    for ch in rest:
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return [t for t in (s.strip() for s in out) if t]


def parse_instr(stmt: str) -> Instr:
    stmt = stmt.strip()
    pred: Optional[Tuple[bool, str]] = None
    if stmt.startswith("@"):
        ptok, stmt = stmt.split(None, 1)
        neg = ptok.startswith("@!")
        pred = (neg, ptok[2 if neg else 1:])
    if " " in stmt or "\t" in stmt:
        opcode, rest = re.split(r"\s+", stmt, maxsplit=1)
    else:
        opcode, rest = stmt, ""
    operands: List[object] = []
    for tok in _split_operands(rest):
        if "|" in tok and tok.startswith("%"):
            a, b = tok.split("|", 1)
            operands.append(Reg(a.strip()))
            operands.append(Reg(b.strip()))
        else:
            operands.append(_parse_operand(tok))
    return Instr(opcode=opcode, operands=operands, pred=pred)


def parse(text: str) -> Module:
    text = _strip_comments(text)
    module = Module()
    first_entry = _ENTRY.search(text)
    header = text[:first_entry.start()] if first_entry else text
    for regex, attr in ((_VERSION, "version"), (_TARGET, "target"),
                        (_ADDR_SIZE, "address_size")):
        m = regex.search(header)
        if m:
            setattr(module, attr, m.group(1).strip())
    pos = 0
    while True:
        m = _ENTRY.search(text, pos)
        if not m:
            break
        name = m.group(1)
        # parameter list up to matching ')'
        depth, i = 1, m.end()
        while depth:
            if text[i] == "(":
                depth += 1
            elif text[i] == ")":
                depth -= 1
            i += 1
        params = [(pn, pt) for pt, pn in _PARAM.findall(text[m.end() - 1:i])]
        # body between the braces
        j = text.index("{", i)
        depth, k = 1, j + 1
        while depth:
            if text[k] == "{":
                depth += 1
            elif text[k] == "}":
                depth -= 1
            k += 1
        body_text = text[j + 1:k - 1]
        pos = k
        kernel = Kernel(name=name, params=params)
        _parse_body(kernel, body_text)
        kernel.renumber()
        module.kernels.append(kernel)
    return module


def _parse_body(kernel: Kernel, body: str) -> None:
    # register declarations
    for m in _REG_DECL.finditer(body):
        kernel.decls.append((m.group(1), m.group(2), int(m.group(3))))
    for m in _REG_DECL_SINGLE.finditer(body):
        kernel.decls.append((m.group(1), m.group(2), 0))
    body = _REG_DECL.sub(" ", body)
    body = _REG_DECL_SINGLE.sub(" ", body)
    # other declarations (shared arrays etc.) are dropped from the subset
    body = re.sub(r"\.(shared|local|const)\s+\.\w+\s+[\w$]+(\[\d+\])?\s*;", " ", body)

    # split into statements on ';' but keep label lines (terminated by ':')
    for chunk in re.split(r";", body):
        chunk = chunk.strip()
        if not chunk:
            continue
        # labels may precede an instruction in the same chunk
        while True:
            lm = re.match(r"^([$\w]+):\s*", chunk)
            if lm and not chunk[: lm.end()].startswith("%"):
                kernel.body.append(Label(lm.group(1)))
                chunk = chunk[lm.end():].strip()
            else:
                break
        if not chunk:
            continue
        kernel.body.append(parse_instr(chunk))


def parse_kernel(text: str, name: Optional[str] = None) -> Kernel:
    module = parse(text)
    if name is None:
        return module.kernels[0]
    return module.kernel(name)
