"""Dry run: trace every (arch x shape x mesh) cell on the meta device.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles each
cell for a 256- or 512-chip pod and reads XLA's memory and cost analyses.
The port has no compiler to ask: ``run_cell`` builds the cell over
``make_rules(make_production_mesh(...))`` (every position on the meta
device) and runs ``fn(*args)`` once, at full width, inside one
``TorchDispatchMode`` (``Tracer``) that counts what each op does.  It
traces and never launches: meta tensors carry shapes and dtypes and no
data, every kernel wrapper returns its result contract's empty tensors and
records the call (``kernels._backend.shape_call``), and CUDA is never
initialised, so it runs on any host.

For each cell this shows, without a card:
  * that the step runs through at its published shapes (every op's
    shapes, the kernels' refusals, the mesh's copies);
  * its work: FLOPs, bytes, transcendentals, kernel calls, ops;
  * its memory: the arguments per device, the live bytes of the whole
    step; and the collective bytes of the cells that move data between
    positions (the kNN cells, and the recommender's cells and the language
    models' prefill and decode cells, whose steps run sharded over the
    mesh: ``distributed.steps``).

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --include-knn --mesh both

Each invocation merges its records into ``--out`` (default
``build/dryrun.json`` at the root of the checkout) by ``arch|shape|mesh``.

A record keeps the reference's keys where the meaning is the same:
``arch``, ``shape``, ``mesh``, ``devices``, ``unrolled``, ``status``
(``ok``, ``skip`` with ``reason``, ``fail`` with ``error`` and ``trace``),
``argument_size_in_bytes`` and ``output_size_in_bytes`` (per device: each
leaf sharded by the rule table's spec of its logical axes over the mesh,
a leaf with none whole on every device, a leaf already placed over the
mesh (``sharding.Sharded``) its part; an output that is an argument
updated in place as that argument), ``transcendentals`` and the
``collective_*`` keys (``launch.hlo_stats``, one device's share).  Where the
port's meaning differs, the key is its own:

  * ``flops``: the whole step's products by ``torch.utils.flop_counter``'s
    formulas, plus each kernel call's (2 m n d for the matmul-form kernels),
    summed over every position; the reference's is one device's;
  * ``bytes_accessed``: every op's operands and results, views and bare
    allocations excepted, plus each kernel call's bytes; no fusion, so a
    ceiling;
  * ``peak_memory_in_bytes_unsharded``: the most bytes live at once while
    the step ran, the arguments included, each storage counted once across
    its views and released when freed (an in-place write allocates
    nothing), over every position of the mesh.  The port runs an LM train
    step or a GNN step whole on one device, so there it is not the
    reference's per-device ``peak_memory_in_bytes``; a recommender's cell
    and an LM prefill or decode cell run sharded, and their records add
    ``peak_memory_in_bytes``, that peak over the positions (the positions
    run one program, so it is each one's mean).  An LM serve step traces
    one position's program for all (``spmd``'s symmetric bodies: each op
    and each new storage counted once for every position it stands for),
    so its positions' transients count as if they ran at once;
  * ``trace_s``, ``kernel_calls`` (calls by kernel) and ``op_counts``
    (calls by ATen op) are the port's alone.

The kNN, recommender and LM serve cells move data between positions
(``core.distributed``'s collectives); the LM train and GNN cells' records
say ``"collectives": "not modelled: ..."``.  The port's loops are Python loops, so every trip is
counted with or without ``--unroll``, which only sets ``unrolled``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import Sharded
from repro_torch.kernels._backend import nbytes, shape_calls
from repro_torch.launch import hlo_stats

OUT = Path(__file__).resolve().parents[3] / "build" / "dryrun.json"

# Ops whose every output element costs one transcendental evaluation
# (XLA's exp, log, tanh, rsqrt, logistic and erf, and the ops built on them).
TRANSCENDENTAL = frozenset({
    "aten.exp", "aten.exp2", "aten.expm1", "aten.log", "aten.log2", "aten.log10",
    "aten.log1p", "aten.tanh", "aten.rsqrt", "aten.sigmoid", "aten.erf", "aten.erfinv",
    "aten._softmax", "aten._log_softmax", "aten.silu", "aten.gelu",
})
# Ops that only allocate: their result is written by the next op.
ALLOCATORS = frozenset({"aten.empty", "aten.empty_like", "aten.empty_strided",
                        "aten.new_empty", "aten.new_empty_strided"})
NOT_MODELLED = ("not modelled: the port runs this step whole on one device "
                "(the recommender's steps and the language models' prefill and decode "
                "run sharded: distributed/steps.py)")


def _tensors(tree, every_part: bool = False) -> list:
    """The tensors of ``tree``; a ``Sharded`` leaf its first part (one
    device's), or every part with ``every_part``."""
    out = []
    for t in tree_flatten(tree)[0]:
        if isinstance(t, Sharded):
            out.extend(t.parts if every_part else t.parts[:1])
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _signature(x):
    """A hashable stand-in for an op's argument as a meta op sees it (a
    tensor's shape, strides and dtype), or raise TypeError."""
    if isinstance(x, torch.Tensor):
        return (x.dtype, x.shape, x.stride())
    if isinstance(x, (list, tuple)):
        return (type(x), *map(_signature, x))
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    hash(x)
    return (type(x), x)


def _functional(func) -> bool:
    """An op that returns fresh tensors and writes none of its operands."""
    schema = func._schema
    return not func.is_view and not schema.is_mutable and all(
        r.alias_info is None for r in schema.returns)


def _in_place(func) -> bool:
    """An op that writes an operand and returns it (``add_``, ``index_copy_``)."""
    rets = func._schema.returns
    return func._schema.is_mutable and bool(rets) and all(
        r.alias_info is not None and r.alias_info.is_write for r in rets)


def _aliases(out, operands) -> bool:
    """True if a result shares its storage with an operand."""
    ins = {id(t.untyped_storage()) for t in _tensors(operands)}
    return any(id(t.untyped_storage()) in ins for t in _tensors(out))


class Tracer(TorchDispatchMode):
    """Counts every op dispatched while it is active: FLOPs, bytes,
    transcendentals and op calls, and the live bytes of storages (module
    docstring).

    On meta tensors a functional op's results depend on its operands'
    shapes, strides and dtypes alone, and a mesh program repeats the same
    ops on every position: the first call of each (op, signature) runs the
    op's meta kernel and keeps its results' layout and its counts, and
    every later one makes empty results of that layout, as many times
    faster as the meta kernels are slow (they run in Python).  Likewise an
    op that writes an operand in place returns that operand again, and a
    view op (one result) the same view of its input (``as_strided``)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.transcendentals = 0.0
        self.op_counts: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._storages: dict[int, tuple] = {}  # id -> (bytes, weakref)
        self._memo: dict = {}
        self._functional: dict = {}

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed (once across views;
        inside a symmetric body's op, once for each position it stands
        for: ``spmd.weight``)."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes() * spmd.weight()
        self._storages[key] = (n, weakref.ref(st, lambda _, key=key: self._release(key)))
        self.live += n
        if self.live > self.peak:
            self.peak = self.live

    def _release(self, key: int) -> None:
        n, _ = self._storages.pop(key, (0, None))
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = None
        kind = self._functional.get(func)
        if kind is None:
            kind = self._functional[func] = (
                "functional" if _functional(func) else "in_place" if _in_place(func) else
                # detach's alias outlives an as_strided one (a live-bytes peak moved)
                "view" if func.is_view and func.overloadpacket is not torch.ops.aten.detach
                else False)
        if kind:
            try:
                key = (func, _signature(args), _signature(kwargs) if kwargs else None)
            except TypeError:  # an unhashable argument: run the op
                key = None
        hit = None if key is None else self._memo.get(key)
        if hit is not None and kind != "functional":
            how, counts = hit
            if kind == "in_place":
                out = args[how]
            else:
                shape, stride, delta = how
                out = torch.as_strided(args[0], shape, stride, args[0].storage_offset() + delta)
            self.track(out)
            self._note(counts)
            return out
        if hit is None:
            before = [(a.shape, a.stride(), a.untyped_storage().nbytes())
                      if isinstance(a, torch.Tensor) else None for a in args]
            out = func(*args, **kwargs)
            counts = self._count(func, args, kwargs, out)
            if key is not None and kind == "in_place":
                where = [j for j, a in enumerate(args) if a is out]
                # Only a write that leaves its operand's layout and storage as
                # they were (not ``resize_``, ``t_``, an ``out=`` that grows).
                if where and before[where[0]] == (out.shape, out.stride(),
                                                  out.untyped_storage().nbytes()):
                    self._memo[key] = (where[0], counts)
                else:
                    self._functional[func] = False
            elif key is not None and kind == "view":
                if (isinstance(out, torch.Tensor) and args and isinstance(args[0], torch.Tensor)
                        and out.dtype == args[0].dtype
                        and out.untyped_storage()._cdata == args[0].untyped_storage()._cdata):
                    self._memo[key] = ((out.shape, out.stride(),
                                        out.storage_offset() - args[0].storage_offset()), counts)
            elif key is not None and _aliases(out, (args, kwargs)):
                # A view its schema does not declare (``_unsafe_view``):
                # never made anew.
                self._functional[func] = False
            elif key is not None:
                leaves, spec = tree_flatten(out)
                layout = [(t.shape, t.stride(), t.dtype) if isinstance(t, torch.Tensor)
                          else (None, t, None) for t in leaves]
                self._memo[key] = (spec, layout, counts)
        else:
            spec, layout, counts = hit
            made = [v if shape is None else torch.empty_strided(shape, v, dtype=dt, device="meta")
                    for shape, v, dt in layout]
            out = made[0] if spec.is_leaf() else tree_unflatten(made, spec)
        self._note(counts)
        for t in (made if hit is not None else _tensors(out)):
            if isinstance(t, torch.Tensor):
                self.track(t)
        return out

    def _note(self, counts) -> None:
        name, flops, moved, trans = counts
        w = spmd.weight()
        self.op_counts[name] = self.op_counts.get(name, 0) + w
        self.flops += flops * w
        self.bytes_accessed += moved * w
        self.transcendentals += trans * w

    def _count(self, func, args, kwargs, out) -> tuple:
        """(op name, FLOPs, bytes, transcendentals) of one call."""
        packet = func.overloadpacket
        name = str(packet)
        flops = 0
        if packet in self._flop_registry:
            flops = self._flop_registry[packet](*args, **kwargs, out_val=out)
        outs = _tensors(out)
        moved = 0
        if not func.is_view and name not in ALLOCATORS:
            moved = nbytes(*_tensors((args, kwargs)), *outs)
        trans = sum(t.numel() for t in outs) if name in TRANSCENDENTAL else 0
        return name, flops, moved, trans


# ---------------------------------------------------------------------------
# Per-device sizes: each argument leaf by its logical axes.
# ---------------------------------------------------------------------------


def _is_axes(ax) -> bool:
    return isinstance(ax, tuple) and all(a is None or isinstance(a, str) for a in ax)


def _leaves_with_axes(val, ax):
    """(tensor, logical axes or None) for each tensor of ``val``, with
    ``ax`` the matching tree of axes (a dict, a sequence, an axes tuple
    that applies to every tensor under it, or None)."""
    from repro_torch.distributed.sharding import Sharded

    if isinstance(val, Sharded):  # placed already: its part is one device's
        yield val.parts[0], None
    elif isinstance(val, torch.Tensor):
        yield val, ax if _is_axes(ax) else None
    elif isinstance(val, dict):
        for key, v in val.items():
            yield from _leaves_with_axes(v, ax.get(key) if isinstance(ax, dict) else ax)
    elif isinstance(val, (list, tuple)):
        same = isinstance(ax, (list, tuple)) and not _is_axes(ax) and len(ax) == len(val)
        for i, v in enumerate(val):
            yield from _leaves_with_axes(v, ax[i] if same else ax)


def _shards(rules, t: torch.Tensor, ax) -> int:
    """How many ways ``t`` splits under the rules' spec of ``ax`` (1: whole)."""
    if ax is None or len(ax) != t.ndim:
        return 1
    n = 1
    for part in rules.spec(ax, tuple(t.shape)):
        for a in () if part is None else (part,) if isinstance(part, str) else part:
            n *= rules.mesh.shape[a]
    return n


def _arg_axes(arch, cell, cfg, shape: str, smoke: bool, variant):
    """The logical axes of ``arch.build(...)``'s arguments, a tree of their
    structure: the params' and the optimizer moments' from the param tree,
    batches by their batch axes, caches and the kNN operands by the axes of
    the reference's steps (``repro/distributed/steps.py``)."""
    from repro_torch.distributed import steps as ST
    from repro_torch.models.nn import split_params

    if arch.family == "knn":
        if cell.kind == "allpairs":
            return (("ring", None), None)
        return (("batch", None), ("table", None), None)
    if arch.family == "gnn":
        abstract = arch.abstract_params(cfg, cell)
        if cell.params["task"] == "classify":
            _, baxes = ST.gnn_classifier_loss(cfg, cell.params["n_classes"])
        else:
            _, baxes = ST.gnn_potential_loss(cfg)
    else:
        abstract = arch.abstract_params(cfg)
    _, axes = split_params(abstract)
    state = ST.TrainState(axes, (None, axes, axes))
    if arch.family == "lm":
        if cell.kind == "train":
            return (state, ST.lm_loss(cfg)[1])
        seq = "kv_seq" if cell.kind == "decode" and variant == "sp" else "seq"
        kv = (None, "batch", seq, "kv_heads", None)
        if cell.kind == "prefill":
            return (axes, ("batch", None), (kv, kv, ("batch",)))
        return (axes, (kv, kv, ("batch",)), ("batch",))
    if arch.family == "gnn":
        return (state, baxes)
    if cell.kind == "train":
        return (state, ST.recsys_loss(arch.id, cfg)[1])
    if cell.kind == "retrieval":
        return (axes, (None, None), ("table", None))
    specs = arch.input_specs(shape, cfg, smoke=smoke)
    return (axes, {k: ("batch",) + (None,) * (v.ndim - 1) for k, v in specs.items()})


# ---------------------------------------------------------------------------
# One cell.
# ---------------------------------------------------------------------------


def trace_step(fn, args, rules, axes) -> dict:
    """Run ``fn(*args)`` on the meta device under a ``Tracer``, the kernels'
    shape calls and the collectives recorded; the counts as a record."""
    n_dev = math.prod(rules.mesh.shape.values())
    per_device = {}
    arg_bytes = 0
    for t, ax in _leaves_with_axes(args, axes):
        share = nbytes(t) // _shards(rules, t, ax)
        per_device[id(t.untyped_storage())] = share
        arg_bytes += share
    tracer = Tracer()
    for t in _tensors(args, every_part=True):
        tracer.track(t)
    t0 = time.perf_counter()
    prev = torch.autograd.is_multithreading_enabled()
    torch.autograd.set_multithreading_enabled(False)  # backward on this thread, in the mode
    try:
        with shape_calls() as calls, hlo_stats.recording() as events, tracer:
            out = fn(*args)
    finally:
        torch.autograd.set_multithreading_enabled(prev)
    trace_s = time.perf_counter() - t0
    out_bytes = sum(per_device.get(id(t.untyped_storage()), nbytes(t)) for t in _tensors(out))
    kernel_calls: dict[str, int] = {}
    for name, _, _ in calls:
        kernel_calls[name] = kernel_calls.get(name, 0) + 1
    st = hlo_stats.collect_stats(events, n_dev)
    rec = {
        "trace_s": round(trace_s, 3),
        "argument_size_in_bytes": int(arg_bytes),
        "output_size_in_bytes": int(out_bytes),
        "peak_memory_in_bytes_unsharded": int(tracer.peak),
        "flops": float(tracer.flops + sum(f for _, f, _ in calls)),
        "bytes_accessed": float(tracer.bytes_accessed + sum(b for _, _, b in calls)),
        "transcendentals": float(tracer.transcendentals),
        "kernel_calls": kernel_calls,
        "op_counts": dict(sorted(tracer.op_counts.items())),
        "collective_counts": st.counts,
        "collective_result_bytes": st.result_bytes,
        "collective_wire_bytes_per_device": st.wire_bytes_per_device,
    }
    if len(_tensors(args, every_part=True)) > len(_tensors(args)):  # a sharded step
        rec["peak_memory_in_bytes"] = int(tracer.peak // n_dev)
    return rec


def run_cell(arch_id: str, shape: str, multi_pod: bool, *, variant: str | None = None,
             unroll: bool = False, smoke: bool = False, mesh=None) -> dict:
    """Trace one cell (module docstring) and return its record.  ``smoke``
    and ``mesh`` (a mesh of meta positions in place of the production one)
    are for tests."""
    from repro_torch import accounting
    from repro_torch.configs import registry as REG
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_production_mesh, mesh_devices

    mesh_name = "multi" if multi_pod else "single"
    arch = REG.get(arch_id)
    cell = {c.name: c for c in arch.shapes}[shape]
    if cell.kind == "skip":
        return {"arch": arch_id, "shape": shape, "mesh": mesh_name, "status": "skip",
                "reason": cell.reason}
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rules = make_rules(mesh)
    rec = {"arch": arch_id, "shape": shape + (f"+{variant}" if variant else ""),
           "mesh": mesh_name, "devices": mesh_devices(mesh), "unrolled": unroll}
    prev = accounting.unrolled()
    accounting.set_unroll(unroll)
    try:
        kw = {"variant": variant} if variant else {}
        fn, args = arch.build(rules, shape, smoke=smoke, **kw)
        cfg = None
        if arch.family == "gnn":
            cfg = arch._cfg_for(cell, smoke)
        elif arch.family != "knn":
            cfg = arch.smoke_config() if smoke else arch.full_config()
        rec.update(trace_step(fn, args, rules, _arg_axes(arch, cell, cfg, shape, smoke, variant)))
    finally:
        accounting.set_unroll(prev)
    if arch.family not in ("knn", "recsys") and not (arch.family == "lm"
                                                      and cell.kind in ("prefill", "decode")):
        rec["collectives"] = NOT_MODELLED
    rec["status"] = "ok"
    return rec


def merge_out(path, records: list[dict]) -> None:
    data = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    for r in records:
        r = {k: v for k, v in r.items() if not k.startswith("_")}
        data[f'{r["arch"]}|{r["shape"]}|{r["mesh"]}'] = r
    tmp = f"{path}.tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--all", action="store_true", help="every assigned cell")
    ap.add_argument("--include-knn", action="store_true")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--variant", default=None,
                    help="build variant (e.g. 'sp' = sequence-parallel decode)")
    ap.add_argument("--unroll", action="store_true",
                    help="record unrolled=true (the port's loops are counted trip by trip "
                         "either way)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry as REG

    if args.all:
        cells = [(a, s) for a, s, kind, _ in REG.all_cells(args.include_knn)]
    else:
        archs = args.arch or REG.ASSIGNED
        cells = []
        for a in archs:
            shapes = args.shape or [c.name for c in REG.get(a).shapes]
            cells += [(a, s) for s in shapes]

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    records, failures = [], 0
    for a, s in cells:
        for mp in meshes:
            tag = f"{a}/{s}/{'multi' if mp else 'single'}"
            try:
                rec = run_cell(a, s, mp, variant=args.variant, unroll=args.unroll)
            except Exception as e:  # a failing cell is a bug; record & continue
                failures += 1
                rec = {"arch": a, "shape": s, "mesh": "multi" if mp else "single",
                       "status": "fail", "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
            records.append(rec)
            if rec["status"] == "ok":
                sharded = "peak_memory_in_bytes" in rec
                gb = rec["peak_memory_in_bytes" if sharded else
                         "peak_memory_in_bytes_unsharded"] / 2**30
                print(f"[dryrun] {tag:55s} OK  trace={rec['trace_s']:7.1f}s "
                      f"peak={gb:8.2f} GiB {'a device' if sharded else 'unsharded'}  "
                      f"flops={rec['flops']:.3e}", flush=True)
            elif rec["status"] == "skip":
                print(f"[dryrun] {tag:55s} SKIP ({rec['reason'][:60]}...)", flush=True)
            else:
                print(f"[dryrun] {tag:55s} FAIL {rec['error'][:120]}", flush=True)
                if args.verbose:
                    print(rec["trace"])
    merge_out(args.out, records)
    print(f"[dryrun] wrote {args.out}; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
