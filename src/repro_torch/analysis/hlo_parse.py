"""Optimized-HLO text parser: per-computation FLOPs / bytes / collective
tallies propagated through the call graph with while-loop trip counts.
The JAX package's ``repro.analysis.hlo_parse``, unchanged in behaviour:
it reads XLA's text, which the port's dry run does not make, and is kept
so that a dump of the JAX package's programs reads the same here.

XLA's HloCostAnalysis visits a while body once; lax.scan-heavy programs
(layer stacks, grad accumulation, blocked attention) therefore undercount by
the trip product. We parse ``compiled.as_text()``:

  * computations start at column 0 (``%name (...) -> ... {`` / ``ENTRY ...``),
  * op lines are ``%name = <type> <opcode>(%operand, ...) , attrs`` — operand
    shapes are NOT inline, so a per-computation symbol table maps names to
    types (computation parameters included),
  * call edges: ``calls=%c``, ``body=%c`` / ``condition=%c`` (trip count from
    ``known_trip_count`` backend_config), ``to_apply=%c``,
    ``branch_computations={...}``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f16": 2, "bf16": 2, "f32": 4,
    "f64": 8, "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "f8e5m2fnuz": 1, "f8e4m3fnuz": 1, "token": 0, "opaque": 0, "u1": 1,
}

_SHAPE_RE = re.compile(r"\b([a-z]\w*)\[([\d,]*)\]")
_HEADER_RE = re.compile(r"^(ENTRY\s+)?%([\w.\-]+)\s*\(")
_OP_RE = re.compile(
    r"^%([\w.\-]+)\s*=\s*(\([^)]*\)|\S+)\s+([\w\-]+)\(([^)]*)")
_PARAM_RE = re.compile(r"%([\w.\-]+):\s*(\([^)]*\)|[^,)]+)")
_TRIP_RE = re.compile(r'known_trip_count"?[:=]\s*\{"?n"?[:=]"?(\d+)"?\}')
_CALLS_RE = re.compile(r"(?:calls|to_apply|body|condition)=%([\w.\-]+)")
_BRANCH_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_OPERAND_RE = re.compile(r"%([\w.\-]+)")

_COLLECTIVES = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute", "ragged-all-to-all",
                "collective-broadcast"}
# no real data movement / compute
_FREE_OPS = {"get-tuple-element", "tuple", "parameter", "constant", "bitcast",
             "after-all", "partition-id", "replica-id", "iota", "while",
             "conditional", "call", "custom-call", "copy-start", "copy-done",
             "opt-barrier"}


def _type_bytes(type_str: str) -> int:
    return sum(_elems(dims) * _DTYPE_BYTES.get(dt, 4)
               for dt, dims in _SHAPE_RE.findall(type_str))


def _elems(dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n


def _type_dims(type_str: str):
    m = _SHAPE_RE.search(type_str)
    if not m:
        return []
    return [int(d) for d in m.group(2).split(",")] if m.group(2) else []


@dataclass
class Comp:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_counts: dict = field(default_factory=dict)
    calls: list = field(default_factory=list)   # (name, multiplier)
    dus_update_bytes: float = -1.0   # >=0: fused computation rooted at a
                                     # dynamic-update-slice (in-place write)


def parse_hlo(hlo_text: str) -> dict:
    comps: dict = {}
    entry = None
    cur: Comp = None
    symbols: dict = {}

    for raw in hlo_text.splitlines():
        if raw.startswith(("HloModule", "//", "FileNames")) or not raw.strip():
            continue
        hm = _HEADER_RE.match(raw)
        if hm and raw.rstrip().endswith("{"):
            cur = Comp()
            comps[hm.group(2)] = cur
            if hm.group(1):
                entry = hm.group(2)
            symbols = {}
            # computation parameters carry their types in the header
            for pname, ptype in _PARAM_RE.findall(raw):
                symbols[pname] = ptype
            continue
        if raw.startswith("}"):
            cur = None
            continue
        if cur is None:
            continue
        line = raw.strip()
        om = _OP_RE.match(line)
        if not om:
            continue
        name, otype, opcode, args = om.groups()
        symbols[name] = otype
        operands = _OPERAND_RE.findall(args)

        # call edges (fusions, while bodies, reduces, conditionals)
        attrs = line[om.end():]
        trip = 1
        tm = _TRIP_RE.search(attrs)
        if tm:
            trip = int(tm.group(1))
        callees = _CALLS_RE.findall(attrs)
        bm = _BRANCH_RE.search(attrs)
        if bm:
            callees += _OPERAND_RE.findall(bm.group(1))
        # bytes flow only through control-flow edges: a fusion/reducer body's
        # internal ops never touch HBM (its operands/result are counted at
        # the call site); while/conditional bodies DO re-touch HBM per trip.
        control = opcode in ("while", "conditional", "call")
        for c in callees:
            cur.calls.append((c, trip, control))

        base = opcode.removesuffix("-start").removesuffix("-done")
        if base in _FREE_OPS:
            continue
        if opcode.endswith("-done"):
            continue

        out_bytes = _type_bytes(otype)
        in_bytes = sum(_type_bytes(symbols.get(o, "")) for o in operands)

        if base in _COLLECTIVES:
            # per-chip wire bytes (ring formulas, (N-1)/N ~= 1):
            #   all-reduce: 2x payload; all-gather: output; reduce-scatter:
            #   input; all-to-all / permute: payload.
            if base == "all-reduce":
                wire = 2.0 * out_bytes
            elif base == "all-gather":
                wire = out_bytes
            elif base == "reduce-scatter":
                wire = in_bytes
            else:
                wire = max(in_bytes, out_bytes)
            cur.coll_bytes += wire
            cur.coll_counts[base] = cur.coll_counts.get(base, 0) + 1
            cur.bytes += 2.0 * out_bytes
            continue

        if opcode == "dot" and len(operands) >= 2:
            result_elems = _elems(_SHAPE_RE.search(otype).group(2)
                                  if _SHAPE_RE.search(otype) else "")
            rhs_dims = _type_dims(symbols.get(operands[1], ""))
            rc = re.search(r"rhs_contracting_dims=\{([\d,]*)\}", attrs)
            contracted = 1
            if rc and rc.group(1):
                for ci in rc.group(1).split(","):
                    i = int(ci)
                    if i < len(rhs_dims):
                        contracted *= rhs_dims[i]
            cur.flops += 2.0 * result_elems * contracted
            cur.bytes += in_bytes + out_bytes  # dots genuinely read operands
            continue
        if opcode == "convolution" and len(operands) >= 2:
            result_dims = _type_dims(otype)
            kern_elems = 1
            for d in _type_dims(symbols.get(operands[1], "")):
                kern_elems *= d
            out_feat = result_dims[-1] if result_dims else 1
            cur.flops += 2.0 * _elems(
                ",".join(map(str, result_dims))) * kern_elems / max(out_feat, 1)
            cur.bytes += in_bytes + out_bytes
            continue

        if opcode == "dynamic-update-slice" and len(operands) >= 2:
            # in-place update (buffers alias under donation): traffic is the
            # UPDATE slice r+w, not a whole-cache rewrite — matters for the
            # decode cells, whose KV caches are GBs per chip (byte-model v2)
            upd = 2.0 * _type_bytes(symbols.get(operands[1], ""))
            cur.bytes += upd
            if "ROOT" in line:
                cur.dus_update_bytes = upd
            continue

        if opcode == "fusion" and callees and \
                comps.get(callees[0], Comp()).dus_update_bytes >= 0:
            # fusion rooted at a dynamic-update-slice: in-place semantics;
            # count the update traffic, not the whole aliased buffer
            cur.bytes += comps[callees[0]].dus_update_bytes
            continue

        # generic ops (fusions, copies, converts, reduces, slices...):
        # HBM traffic model = 2x result bytes (read ~= write symmetry).
        # Counting raw operand bytes blows up on dynamic-slice ops whose
        # operand is a whole loop-carried activation stack.
        cur.bytes += 2.0 * out_bytes

    memo: dict = {}

    def total(name: str, depth: int = 0):
        if name in memo:
            return memo[name]
        c = comps.get(name)
        if c is None or depth > 128:
            return (0.0, 0.0, 0.0, {})
        memo[name] = (0.0, 0.0, 0.0, {})  # cycle guard
        fl, by, cb = c.flops, c.bytes, c.coll_bytes
        counts = dict(c.coll_counts)
        for callee, mult, control in c.calls:
            cfl, cby, ccb, ccnt = total(callee, depth + 1)
            fl += mult * cfl
            cb += mult * ccb
            if control:
                by += mult * cby
            for k, v in ccnt.items():
                counts[k] = counts.get(k, 0) + mult * v
        memo[name] = (fl, by, cb, counts)
        return memo[name]

    if entry is None and comps:
        entry = list(comps)[-1]
    fl, by, cb, counts = total(entry) if entry else (0.0, 0.0, 0.0, {})
    return {
        "dot_flops": fl,
        "hbm_bytes": by,
        "collective_bytes": cb,
        "collective_counts": counts,
        "entry": entry,
        "n_computations": len(comps),
    }
