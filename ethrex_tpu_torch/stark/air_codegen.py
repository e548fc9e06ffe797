"""Kernel K6: an AIR's constraints as one generated CUDA kernel per group.

Replaces the constraint evaluation inside the jitted `phase_quotient` body
of `ethrex_tpu/stark/prover.py:527-535`, which evaluates `air.constraints`
over the whole LDE domain with `stark/air.py DeviceOps` (one array op per
field op; the port's plain version does the same in PyTorch).

Constraints are written once against an abstract `ops` object
(`stark/air.py`).  `record(air)` runs `air.constraints` once with a
recording `ops` over symbolic inputs (local columns, next-row columns,
periodic columns) and returns an SSA graph of add/sub/mul/const nodes:

  * identical nodes are shared (add and mul are commutative, so their
    operands are ordered first), which removes the many repeated
    sub-expressions of the AIR code (the FriVerifyAir builds the same
    absorbed state once per output limb);
  * constant operands fold, and x + 0, x - 0, x * 1, x * 0 and x - x
    simplify; every rule gives the canonical residue that DeviceOps
    computes, so the values are bit-equal.

`cuda_source(graph, mode=...)` emits CUDA C++ for that graph: a thread
per LDE point i reads lde[j, i] and lde[j, (i + B) mod N] in place (no
rolled copy of the LDE, 6 GB at the outer proof's size), and the periodic
columns at i.  Inputs are read right before their first use.  Two modes:

  * "combine" (the prover's, `combine`): as each constraint value v_k is
    made, the thread adds v_k * apow[k] into four lazy 64-bit sums (raw
    products, `bb::mad`, folded after every fourth term), reduces each
    once and writes the point's (N, 4) row of the alpha combination: the
    reference's (K, N) constraint block and its matmul with the alpha
    powers (prover.py:527-535) in one pass that writes 16 bytes a point.
    The group's alpha powers travel as a kernel parameter (the constant
    bank: every thread reads the same words), hence at most
    MAX_CONSTRAINTS_PER_KERNEL constraints a kernel.
  * "evaluate" (`evaluate`, test-only): writes the (K, N) block; it shows
    which constraint is wrong when the combination disagrees.

Graphs larger than `MAX_NODES_PER_KERNEL` are split into several kernels
by groups of consecutive constraints (each recomputes the shared nodes it
needs): on the H100 one straight-line kernel per AIR ran 3-4x slower than
kernels of about 1,200 nodes, and 300-node kernels recompute too much
(`tools/air_kernel_split.py`).  In combine mode group 0 writes the result
and each later group adds its sum mod p, in order on one stream (no
atomics).  The source goes to `build/ethrex_tpu_torch/air/<hash>.cu` and
is compiled and loaded by `kernels.load_generated`; only the repo's own
AIR classes are traced.

Bound on this card: the combine kernel reads each trace and periodic
column once and writes 4 words per point; its arithmetic is the graph's
Montgomery products (each group's own) and 4 K raw products a point,
which bound it.  It runs 3.5-6x over that bound on the H100, no faster
than the block form alone did, so its time is not its bytes (PERF.md).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import kernels
from ..ops import babybear as bb
from .air import Air, DeviceOps

# the largest graph one generated kernel holds before it is split (swept
# again in combine mode: fastest for StateUpdateAir and FriVerifyAir)
MAX_NODES_PER_KERNEL = 1200
# the most constraints one kernel holds: a combine kernel takes its
# constraints' alpha powers (16 bytes each) as a kernel parameter, and
# CUDA's classic parameter block is 4 KB
MAX_CONSTRAINTS_PER_KERNEL = 240
_THREADS = 128

# node kinds
IN_LOCAL, IN_NEXT, IN_PERIODIC, CONST, ADD, SUB, MUL = range(7)
_KIND_NAMES = ("local", "next", "periodic", "const", "add", "sub", "mul")


@dataclasses.dataclass(frozen=True)
class Sym:
    """A value of the recorded graph: the index of its node."""
    idx: int


class RecordingOps:
    """An `ops` object that records instead of computing (see module
    doc).  Nodes are tuples (kind, a, b): a column index for the inputs,
    the canonical value for CONST, operand node indices otherwise."""

    def __init__(self):
        self.nodes: list[tuple] = []
        self._index: dict = {}

    def _node(self, key: tuple) -> Sym:
        idx = self._index.get(key)
        if idx is None:
            idx = len(self.nodes)
            self.nodes.append(key)
            self._index[key] = idx
        return Sym(idx)

    def input(self, kind: int, col: int) -> Sym:
        return self._node((kind, col, 0))

    def const(self, v: int) -> Sym:
        return self._node((CONST, int(v) % bb.P, 0))

    def _const_of(self, s: Sym):
        node = self.nodes[s.idx]
        return node[1] if node[0] == CONST else None

    def add(self, a: Sym, b: Sym) -> Sym:
        ca, cb = self._const_of(a), self._const_of(b)
        if ca is not None and cb is not None:
            return self.const((ca + cb) % bb.P)
        if cb == 0:
            return a
        if ca == 0:
            return b
        lo, hi = sorted((a.idx, b.idx))
        return self._node((ADD, lo, hi))

    def sub(self, a: Sym, b: Sym) -> Sym:
        ca, cb = self._const_of(a), self._const_of(b)
        if ca is not None and cb is not None:
            return self.const((ca - cb) % bb.P)
        if cb == 0:
            return a
        if a.idx == b.idx:
            return self.const(0)
        return self._node((SUB, a.idx, b.idx))

    def mul(self, a: Sym, b: Sym) -> Sym:
        ca, cb = self._const_of(a), self._const_of(b)
        if ca is not None and cb is not None:
            return self.const(ca * cb % bb.P)
        if ca == 0 or cb == 0:
            return self.const(0)
        if cb == 1:
            return a
        if ca == 1:
            return b
        lo, hi = sorted((a.idx, b.idx))
        return self._node((MUL, lo, hi))


@dataclasses.dataclass
class Graph:
    """An AIR's constraints as SSA nodes; `outputs[k]` is the node of
    constraint k."""
    name: str
    nodes: list
    outputs: list
    width: int
    num_periodic: int

    @property
    def num_constraints(self) -> int:
        return len(self.outputs)

    def counts(self) -> dict:
        live = self.reachable(range(len(self.outputs)))
        out = {name: 0 for name in _KIND_NAMES}
        for i in live:
            out[_KIND_NAMES[self.nodes[i][0]]] += 1
        return out

    def reachable(self, constraint_ids) -> list:
        """Sorted node indices the given constraints depend on."""
        seen = set()
        stack = [self.outputs[k] for k in constraint_ids]
        while stack:
            i = stack.pop()
            if i in seen:
                continue
            seen.add(i)
            kind, a, b = self.nodes[i]
            if kind >= ADD:
                stack.append(a)
                stack.append(b)
        return sorted(seen)


_GRAPHS: dict = {}


def record(air: Air) -> Graph:
    """Trace `air.constraints` once with a recording ops (cached per AIR
    structure)."""
    key = air.cache_key()
    cached = _GRAPHS.get(key)
    if cached is not None:
        return cached
    ops = RecordingOps()
    local = [ops.input(IN_LOCAL, j) for j in range(air.width)]
    nxt = [ops.input(IN_NEXT, j) for j in range(air.width)]
    periodic = [ops.input(IN_PERIODIC, k) for k in range(air.num_periodic)]
    outs = air.constraints(local, nxt, periodic, ops)
    for o in outs:
        if not isinstance(o, Sym):
            raise TypeError(f"{type(air).__name__}.constraints returned "
                            f"{type(o).__name__}, not a recorded value")
    graph = Graph(name=type(air).__name__, nodes=list(ops.nodes),
                  outputs=[o.idx for o in outs], width=air.width,
                  num_periodic=air.num_periodic)
    _GRAPHS[key] = graph
    return graph


# ---------------------------------------------------------------------------
# plain interpreter of the graph (the CPU tests hold it against DeviceOps)
# ---------------------------------------------------------------------------

def interpret(graph: Graph, lde_cols, periodic, B: int) -> torch.Tensor:
    """Evaluate the recorded graph with the plain PyTorch field ops:
    lde_cols (w, N), periodic (P, N) -> (K, N) int32 Montgomery."""
    w, N = lde_cols.shape
    dev = lde_cols.device
    idx_next = (torch.arange(N, device=dev) + B) % N
    vals: dict = {}
    for i in graph.reachable(range(graph.num_constraints)):
        kind, a, b = graph.nodes[i]
        if kind == IN_LOCAL:
            v = lde_cols[a]
        elif kind == IN_NEXT:
            v = lde_cols[a][idx_next]
        elif kind == IN_PERIODIC:
            v = periodic[a]
        elif kind == CONST:
            v = bb.const(a, dev).expand(N)
        elif kind == ADD:
            v = bb.add(vals[a], vals[b])
        elif kind == SUB:
            v = bb.sub(vals[a], vals[b])
        else:
            v = bb.mont_mul(vals[a], vals[b])
        vals[i] = v
    return torch.stack([vals[o].expand(N) for o in graph.outputs])


# ---------------------------------------------------------------------------
# CUDA source
# ---------------------------------------------------------------------------

def groups(graph: Graph, max_nodes: int = MAX_NODES_PER_KERNEL) -> list:
    """Split the constraints into runs of consecutive constraints whose
    joint graph holds at most `max_nodes` nodes (a constraint whose own
    graph is larger stands alone) and at most
    MAX_CONSTRAINTS_PER_KERNEL constraints."""
    out = []
    cur: list = []
    for k in range(graph.num_constraints):
        trial = cur + [k]
        if cur and (len(trial) > MAX_CONSTRAINTS_PER_KERNEL
                    or len(graph.reachable(trial)) > max_nodes):
            out.append(cur)
            cur = [k]
        else:
            cur = trial
    if cur:
        out.append(cur)
    return out


_ACC = ("c0", "c1", "c2", "c3")


def _kernel_body(graph: Graph, cids: list, gi: int,
                 combine: bool = False) -> list:
    """One group's kernel.  Evaluate mode writes each constraint's column
    of the (K, N) block; combine mode adds v_k * apow[k] into four lazy
    64-bit sums as each v_k is made (bb::mad; bb::fold after every fourth
    term keeps them below 2^64), reduces each once (bb::redc) and writes,
    or for a later group adds mod p to, the point's (N, 4) row."""
    if combine:
        lines = [
            f"struct Alpha{gi} {{ uint32_t w[{4 * len(cids)}]; }};",
            f"__global__ void __launch_bounds__({_THREADS}) air_c{gi}(",
            "    const uint32_t* __restrict__ lde,",
            "    const uint32_t* __restrict__ per,",
            "    uint32_t* __restrict__ out, long long N, long long B,",
            f"    const Alpha{gi} ap) {{",
        ]
    else:
        lines = [
            f"__global__ void __launch_bounds__({_THREADS}) air_k{gi}(",
            "    const uint32_t* __restrict__ lde,",
            "    const uint32_t* __restrict__ per,",
            "    uint32_t* __restrict__ out, long long N, long long B) {",
        ]
    lines += [
        "  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;",
        "  if (i >= N) return;",
        "  long long inx = (i + B) & (N - 1);",
    ]
    if combine:
        lines.append("  unsigned long long " + ", ".join(
            f"{c} = 0" for c in _ACC) + ";")
    writes: dict = {}
    for k in cids:
        writes.setdefault(graph.outputs[k], []).append(k)
    loaded: set = set()
    terms = [0]

    def emit(i, expr):
        lines.append(f"  const uint32_t v{i} = {expr};")
        for k in writes.get(i, ()):
            if not combine:
                lines.append(f"  out[{k}LL * N + i] = v{i};")
                continue
            t = 4 * (k - cids[0])
            lines.append("  " + " ".join(
                f"{c} = bb::mad(v{i}, ap.w[{t + j}], {c});"
                for j, c in enumerate(_ACC)))
            terms[0] += 1
            if terms[0] % 4 == 0:
                lines.append("  " + " ".join(f"{c} = bb::fold({c});"
                                             for c in _ACC))

    def load(i):
        # an input or constant is read right before its first use, not
        # all up front
        kind, a, _ = graph.nodes[i]
        if kind >= ADD or i in loaded:
            return
        loaded.add(i)
        if kind == IN_LOCAL:
            emit(i, f"lde[{a}LL * N + i]")
        elif kind == IN_NEXT:
            emit(i, f"lde[{a}LL * N + inx]")
        elif kind == IN_PERIODIC:
            emit(i, f"per[{a}LL * N + i]")
        else:
            emit(i, f"{a * bb._R % bb.P}u")

    for i in graph.reachable(cids):
        kind, a, b = graph.nodes[i]
        if kind < ADD:
            if i in writes:
                load(i)
            continue
        load(a)
        load(b)
        op = {ADD: "add", SUB: "sub", MUL: "mul"}[kind]
        emit(i, f"bb::{op}(v{a}, v{b})")
    if combine:
        lines.append("  uint4 r = make_uint4(" + ", ".join(
            f"bb::redc(bb::fold({c}))" for c in _ACC) + ");")
        lines.append("  uint4* o = reinterpret_cast<uint4*>(out) + i;")
        if gi:
            # later groups add to the earlier groups' sum, in stream order
            lines += ["  const uint4 q = *o;",
                      "  r = make_uint4(bb::add(q.x, r.x), bb::add(q.y, "
                      "r.y), bb::add(q.z, r.z), bb::add(q.w, r.w));"]
        lines.append("  *o = r;")
    lines.append("}")
    return lines


MODES = ("evaluate", "combine")


def cuda_source(graph: Graph, max_nodes: int = MAX_NODES_PER_KERNEL,
                mode: str = "evaluate"):
    """(source text, number of kernels) for the graph in `mode`:
    "evaluate" writes the (K, N) constraint block (entries
    air_launch_<g>), "combine" its alpha combination (N, 4) (entries
    air_combine_launch_<g>, which take the group's alpha powers as a host
    pointer).  The text is a function of the graph and the mode alone, so
    the same AIR always gives the same source and the same build."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    combine = mode == "combine"
    parts = groups(graph, max_nodes)
    lines = [
        f"// Generated by ethrex_tpu_torch/stark/air_codegen.py from "
        f"{graph.name} ({mode}):",
        f"// {graph.num_constraints} constraints, width {graph.width}, "
        f"{graph.num_periodic} periodic columns, {len(parts)} kernel(s).",
        "// Kernel K6: replaces the constraint evaluation of the jitted",
        "// phase_quotient body, ethrex_tpu/stark/prover.py:527"
        + ("-535, with its alpha combination." if combine else "."),
        "#include <cstring>",
        "",
        '#include "babybear.cuh"',
        "",
        "namespace {",
    ]
    for gi, cids in enumerate(parts):
        lines.extend(_kernel_body(graph, cids, gi, combine))
    lines += ["}  // namespace", "", 'extern "C" {', ""]
    grid = (f"<<<(unsigned)((N + {_THREADS - 1}) / {_THREADS}), "
            f"{_THREADS}, 0, stream>>>((const uint32_t*)lde, "
            f"(const uint32_t*)per, (uint32_t*)out, N, B")
    for gi in range(len(parts)):
        if combine:
            lines += [
                f"int air_combine_launch_{gi}(const void* lde, const void* "
                f"per, void* out, const void* alpha, long long N, long long "
                f"B, cudaStream_t stream) {{",
                f"  Alpha{gi} ap;",
                "  memcpy(&ap, alpha, sizeof(ap));",
                f"  air_c{gi}{grid}, ap);",
            ]
        else:
            lines += [
                f"int air_launch_{gi}(const void* lde, const void* per, "
                f"void* out, long long N, long long B, cudaStream_t stream) "
                f"{{",
                f"  air_k{gi}{grid});",
            ]
        lines += ["  return (int)cudaGetLastError();", "}", ""]
    lines.append('}  // extern "C"')
    return "\n".join(lines) + "\n", len(parts)


# ---------------------------------------------------------------------------
# the wrappers: K6 on a CUDA tensor, DeviceOps on a CPU tensor
# ---------------------------------------------------------------------------

def evaluate_plain(air: Air, lde_cols, periodic, B: int) -> torch.Tensor:
    """The plain version: `air.constraints` under DeviceOps over the LDE
    and its rotation by B rows -> (K, N) int32 Montgomery."""
    N = lde_cols.shape[1]
    rolled = torch.roll(lde_cols, -B, dims=1)
    cons = air.constraints(list(lde_cols.unbind(0)), list(rolled.unbind(0)),
                           list(periodic.unbind(0)), DeviceOps(
                               lde_cols.device))
    del rolled
    return torch.stack([c.expand(N) for c in cons])


def combine_plain(air: Air, lde_cols, periodic, B: int,
                  apow) -> torch.Tensor:
    """The plain version of `combine`: the (K, N) block of
    `evaluate_plain`, then `mod_matmul_plain(block.T, apow[:K])` (the
    reference's `acc`, ethrex_tpu/stark/prover.py:535)."""
    K = air.num_constraints
    cons = evaluate_plain(air, lde_cols, periodic, B)
    return bb.mod_matmul_plain(cons.T, apow[:K].to(lde_cols.device))


_LIBS: dict = {}
_ARGTYPES = {"evaluate": [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
             + [ctypes.c_void_p],
             "combine": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
             + [ctypes.c_void_p]}
_ENTRY = {"evaluate": "air_launch_", "combine": "air_combine_launch_"}


def build(air: Air, max_nodes: int = MAX_NODES_PER_KERNEL,
          mode: str = "evaluate"):
    """Generate, compile and load the AIR's kernels in `mode`; returns
    (ctypes library, constraint groups).  The build is cached by the
    source's hash, and the loaded library per (AIR structure, node cap,
    mode), so a launch generates no source (tens of ms of host work for
    the larger AIRs) and the two modes never share a library."""
    key = (air.cache_key(), max_nodes, mode)
    got = _LIBS.get(key)
    if got is None:
        graph = record(air)
        text, nk = cuda_source(graph, max_nodes, mode)
        got = (kernels.load_generated(
            text, [f"{_ENTRY[mode]}{g}" for g in range(nk)],
            _ARGTYPES[mode]), groups(graph, max_nodes))
        _LIBS[key] = got
    return got


def _check_inputs(air: Air, lde_cols, periodic, name: str):
    kernels.require_int32_cuda(lde_cols, f"{name} lde_cols")
    w, N = lde_cols.shape
    if w != air.width or N & (N - 1):
        raise ValueError(f"lde_cols {tuple(lde_cols.shape)}: expected "
                         f"({air.width}, 2^k)")
    if periodic.shape != (air.num_periodic, N):
        raise ValueError(f"periodic {tuple(periodic.shape)}: expected "
                         f"({air.num_periodic}, {N})")
    per = periodic.contiguous()
    if air.num_periodic:
        kernels.require_int32_cuda(per, f"{name} periodic")
    return lde_cols.contiguous(), per, N


def evaluate(air: Air, lde_cols, periodic, B: int,
             max_nodes: int = MAX_NODES_PER_KERNEL) -> torch.Tensor:
    """Constraint block (K, N) of `air` over lde_cols (w, N) and the
    periodic LDEs (P, N), all int32 Montgomery.  Kernel K6 (evaluate mode)
    on a CUDA tensor; the plain version on a CPU tensor.  No prover path
    calls it since the alpha combination moved into `combine`; it stays
    to show which constraint is wrong when `combine` disagrees.
    `max_nodes` caps one generated kernel's graph (see `groups`)."""
    if lde_cols.device.type != "cuda":
        return evaluate_plain(air, lde_cols, periodic, B)
    lde_cols, per, N = _check_inputs(air, lde_cols, periodic, "air")
    lib, parts = build(air, max_nodes)
    out = torch.empty((air.num_constraints, N), dtype=bb.I32,
                      device=lde_cols.device)
    stream = torch.cuda.current_stream(lde_cols.device).cuda_stream
    per_ptr = kernels.ptr(per) if per.numel() else 0
    for g in range(len(parts)):
        kernels.check(getattr(lib, f"air_launch_{g}")(
            kernels.ptr(lde_cols), per_ptr, kernels.ptr(out), N, B, stream),
            f"air_launch_{g}")
        kernels.count("air_constraints")
    return out


def combine(air: Air, lde_cols, periodic, B: int, apow,
            max_nodes: int = MAX_NODES_PER_KERNEL) -> torch.Tensor:
    """The quotient's alpha combination of `air`'s constraints,
    sum_k C_k(x) apow[k], over lde_cols (w, N) and the periodic LDEs
    (P, N): (N, 4) int32 Montgomery, equal to
    `mod_matmul(evaluate(...).T, apow[:K])`.  apow (>= K, 4) Montgomery,
    on any device.  Kernel K6 in combine mode on a CUDA tensor: no (K, N)
    block is made; group 0 writes the result and each later group adds
    to it, in order on the current stream.  The plain version on a CPU
    tensor."""
    K = air.num_constraints
    if apow.shape[0] < K or apow.shape[1:] != (4,):
        raise ValueError(f"apow {tuple(apow.shape)}: expected (>= {K}, 4)")
    if lde_cols.device.type != "cuda":
        return combine_plain(air, lde_cols, periodic, B, apow)
    lde_cols, per, N = _check_inputs(air, lde_cols, periodic, "air_combine")
    # the groups' alpha powers go to each launch as a kernel parameter,
    # from this host copy
    words = np.ascontiguousarray(bb.to_numpy(apow[:K]))
    lib, parts = build(air, max_nodes, "combine")
    out = torch.empty((N, 4), dtype=bb.I32, device=lde_cols.device)
    stream = torch.cuda.current_stream(lde_cols.device).cuda_stream
    per_ptr = kernels.ptr(per) if per.numel() else 0
    base = words.ctypes.data
    for g, cids in enumerate(parts):
        kernels.check(getattr(lib, f"air_combine_launch_{g}")(
            kernels.ptr(lde_cols), per_ptr, kernels.ptr(out),
            base + 16 * cids[0], N, B, stream), f"air_combine_launch_{g}")
        kernels.count("air_combine")
    return out
