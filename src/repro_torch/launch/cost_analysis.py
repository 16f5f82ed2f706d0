"""Per-rank costs of a dry-run cell: the card's rates, the roofline terms,
the collectives a rank puts on the wire, and the counts of a per-rank
program run on ``meta`` tensors (counterpart of
``repro.launch.hlo_analysis``).

The reference reads XLA's analyses of a compiled program: cost analysis,
memory analysis, and the collectives parsed out of the optimized HLO text.
The port has no compiler to ask, so each of them has a counterpart of its
own:

- **counts** (:func:`count`): the rank's program runs eagerly on ``meta``
  tensors (shapes and dtypes, no data, nothing allocated) under
  ``torch.utils.flop_counter.FlopCounterMode`` (the matrix products'
  flops, forward, backward and every recomputation) and a
  ``TorchDispatchMode`` of this module that sums the operand and result
  bytes of every aten op that is not a view (an unfused upper bound on
  the bytes a rank moves through HBM) and tracks the bytes alive: each
  new storage's bytes are added when an op makes it and taken off when
  it is freed, autograd's saved tensors and the ``remat`` recomputation
  included; the peak is the program's temporary memory.  What the
  program does under ``torch.device("meta")`` itself (the parameterless
  module skeletons that ``train_step`` builds to hold its leaves) is not
  counted: on the card it allocates and moves nothing;
- **collectives** (:class:`CollectiveStats`): every collective of
  ``core/distributed.py`` reports its kind, operand bytes and result
  bytes to the recorders that :func:`record_collectives` installs (what
  the wire carries, whether or not gloo stages it through the host); the
  dry run counts a production mesh analytically
  (:func:`train_collectives`, ``dryrun_pald.body_collectives``), and the
  tests hold those counts to the recorder's in a world of ranks;
- **rates** (:data:`PEAK_FLOPS` and the rest): NVIDIA's data sheets for
  one H100 SXM at its 700 W limit (:data:`RATES_SOURCE`); a collective's
  time is its traffic over the slowest link its group crosses
  (:func:`link_bytes_per_s`: NVLink within one 8-card host, the host
  network past it).
"""
from __future__ import annotations

import contextlib
import math
import subprocess
import weakref
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["PEAK_FLOPS", "PEAK_OPS", "HBM_BYTES_PER_S", "LINK_BYTES_PER_S",
           "HOST_NET_BYTES_PER_S", "CARDS_PER_HOST", "RATES_SOURCE",
           "link_bytes_per_s", "CollectiveStats", "record_collectives",
           "roofline_terms", "model_flops", "Counted", "count",
           "tensor_bytes", "group_ranks", "gather_collectives",
           "train_collectives", "card", "device_info", "timed",
           "peak_memory"]

PEAK_FLOPS = 989e12           # bfloat16, dense, tensor cores
PEAK_OPS = 67e12              # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # HBM3
LINK_BYTES_PER_S = 450e9      # NVLink, each way, within one host
HOST_NET_BYTES_PER_S = 50e9   # 400 Gb/s a card (ConnectX-7), past the host
CARDS_PER_HOST = 8            # DGX H100
RATES_SOURCE = (
    "NVIDIA H100 SXM data sheet, 700 W: 989 TFLOP/s bfloat16 dense on the "
    "tensor cores, 67 TFLOP/s float32 outside them, HBM3 3.35 TB/s, NVLink "
    "900 GB/s (450 GB/s each way) within one 8-card host; DGX H100 data "
    "sheet: ConnectX-7 400 Gb/s a card between hosts")

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def card() -> str | None:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them (the rates above
    assume 700 W; a card set below it runs slower), None without one."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def device_info(dev: torch.device) -> dict:
    """{"device": the card's name (or the device type), "card":
    :func:`card` on the card, else None}."""
    if dev.type == "cuda":
        return {"device": torch.cuda.get_device_name(dev), "card": card()}
    return {"device": dev.type, "card": None}


def timed(fn, dev: torch.device, reps: int):
    """``fn()`` once to warm up, then ``reps`` times, each timed by CUDA
    events on the card (the host clock elsewhere): (the last output, the
    median ms, each rep's ms)."""
    import statistics
    import time

    out, times = None, []
    for i in range(reps + 1):
        out = None
        if dev.type == "cuda":
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn()
            e.record()
            e.synchronize()
            ms = s.elapsed_time(e)
        else:
            t0 = time.perf_counter()
            out = fn()
            ms = 1e3 * (time.perf_counter() - t0)
        if i:
            times.append(ms)
    return out, statistics.median(times), times


@contextlib.contextmanager
def peak_memory(dev: torch.device):
    """Yields a namespace whose ``bytes`` is set on leaving the block: the
    card's peak of allocated memory within it above what was allocated
    on entry (None off the card).  The allocator's cache is emptied on
    entry, so what an earlier measurement left cached does not count."""
    from types import SimpleNamespace

    box = SimpleNamespace(bytes=None)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    yield box
    if cuda:
        torch.cuda.synchronize(dev)
        box.bytes = torch.cuda.max_memory_allocated(dev) - base


def link_bytes_per_s(ranks: Iterable[int],
                     per_host: int = CARDS_PER_HOST) -> float:
    """The rate of the slowest link a group of global ``ranks`` crosses
    (one card a rank, ``per_host`` consecutive ranks a host): NVLink when
    every rank is on one host, else the host network."""
    hosts = {int(r) // per_host for r in ranks}
    return LINK_BYTES_PER_S if len(hosts) <= 1 else HOST_NET_BYTES_PER_S


def _traffic(kind: str, op_bytes: int, out_bytes: int) -> int:
    """Modeled link traffic of one collective (the reference's rule):
    all-gather receives out - in; all-reduce moves ~2 x in (ring send +
    receive); reduce-scatter in - out; permute / all-to-all in."""
    if kind == "all-gather":
        return max(out_bytes - op_bytes, 0)
    if kind == "all-reduce":
        return 2 * op_bytes
    if kind == "reduce-scatter":
        return max(op_bytes - out_bytes, 0)
    return op_bytes  # permute, all-to-all


@dataclass
class CollectiveStats:
    """One rank's collectives: kind -> (count, operand bytes, traffic
    bytes), and ``seconds``: each collective's traffic over the rate of
    the slowest link its group crosses, summed."""
    by_kind: dict = field(default_factory=dict)
    seconds: float = 0.0

    def add(self, kind: str, operand: int, result: int,
            ranks: Sequence[int] = (0,)) -> None:
        if kind not in _COLLECTIVES:
            raise ValueError(f"unknown collective kind {kind!r}")
        t = _traffic(kind, int(operand), int(result))
        c, b, tr = self.by_kind.get(kind, (0, 0, 0))
        self.by_kind[kind] = (c + 1, b + int(operand), tr + t)
        self.seconds += t / link_bytes_per_s(ranks)

    @property
    def total_bytes(self) -> int:
        """Operand bytes."""
        return sum(b for _, b, _ in self.by_kind.values())

    @property
    def total_traffic(self) -> int:
        """Modeled link traffic (what the roofline term uses)."""
        return sum(t for _, _, t in self.by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(c for c, _, _ in self.by_kind.values())

    def as_dict(self) -> dict:
        return {
            "total_bytes": self.total_bytes,
            "total_traffic": self.total_traffic,
            "total_count": self.total_count,
            "seconds": self.seconds,
            "by_kind": {
                k: {"count": c, "bytes": b, "traffic": t}
                for k, (c, b, t) in sorted(self.by_kind.items())
            },
        }


@contextlib.contextmanager
def record_collectives():
    """Within the block, every collective this process's ranks run
    through ``core/distributed.py`` adds to the yielded
    :class:`CollectiveStats`."""
    from repro_torch.core import distributed

    stats = CollectiveStats()
    distributed._RECORDERS.append(stats)
    try:
        yield stats
    finally:
        distributed._RECORDERS.remove(stats)


def roofline_terms(*, flops: float, bytes_accessed: float, coll_s: float,
                   chips: int = 1, flops_is_global: bool = False,
                   peak: float = PEAK_FLOPS) -> dict:
    """The three roofline times (seconds) and the dominant term.  The
    port's counts are per rank already (``flops_is_global=False``); the
    collective term ``coll_s`` is :attr:`CollectiveStats.seconds`.
    ``peak``: the compute rate (:data:`PEAK_OPS` for the PaLD passes,
    which are compares and adds, not matrix products)."""
    div = chips if flops_is_global else 1
    terms = {"compute_s": flops / div / peak,
             "memory_s": bytes_accessed / div / HBM_BYTES_PER_S,
             "collective_s": coll_s / div}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]).removesuffix("_s")
    terms["bound_s"] = max(terms["compute_s"], terms["memory_s"],
                           terms["collective_s"])
    return terms


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); D = tokens/step.

    For decode shapes D is the new tokens only (global_batch × 1)."""
    _, active = cfg.param_count()
    if shape.kind == "decode":
        tokens = shape.global_batch
    else:
        tokens = shape.global_batch * shape.seq_len
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active * tokens


# ---------------------------------------------------------------------------
# counting a program on meta tensors
# ---------------------------------------------------------------------------
def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a tree (dicts, lists, tuples, modules:
    their parameters and buffers), each storage counted once."""
    seen, total = set(), 0

    def visit(t):
        nonlocal total
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()

    def walk(x):
        if isinstance(x, torch.Tensor):
            visit(x)
        elif isinstance(x, torch.nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                visit(t)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return total


def _under_meta_device() -> bool:
    """True inside a ``with torch.device("meta"):`` block."""
    from torch.overrides import _get_current_function_mode_stack
    from torch.utils._device import DeviceContext

    return any(isinstance(m, DeviceContext) and m.device.type == "meta"
               for m in _get_current_function_mode_stack())


class _Costs(TorchDispatchMode):
    """Bytes accessed and bytes alive of every aten op in the mode."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.live = self.peak = 0
        self.off_meta: dict = {}      # op name -> bytes made off meta
        self._alive: dict = {}        # id(storage) -> its finalizer

    def _freed(self, key, nbytes):
        self.live -= nbytes
        self._alive.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _under_meta_device():
            return out
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        in_st = {id(t.untyped_storage()) for t in ins}
        fresh = [t for t in outs if id(t.untyped_storage()) not in in_st]
        if not func.is_view and (fresh or func._schema.is_mutable):
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in ins + outs)
        for t in fresh:
            st = t.untyped_storage()
            key = id(st)
            if key in self._alive:
                continue
            nbytes = st.nbytes()
            if t.device.type != "meta" and nbytes:
                name = str(func)
                self.off_meta[name] = self.off_meta.get(name, 0) + nbytes
            self._alive[key] = weakref.finalize(st, self._freed, key, nbytes)
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        return out


@dataclass
class Counted:
    """What :func:`count` read of one call: the matrix products' flops,
    the bytes accessed (unfused upper bound), the peak of the bytes its
    ops made alive at once (``temp_bytes``), the bytes made off the meta
    device by op (``off_meta``; tensors of 0 bytes allocate nothing and
    are left out: ``torch.utils.checkpoint`` makes such placeholders on
    the CPU for every rematerialized call in some torch releases), and
    the wall seconds of the count."""
    flops: float
    bytes_accessed: float
    temp_bytes: int
    off_meta: dict
    seconds: float


def count(fn, *args, **kwargs) -> Counted:
    """Run ``fn(*args, **kwargs)`` under the flop counter and the byte
    tracker (module docstring); on ``meta`` tensors nothing is
    allocated."""
    import time

    from torch.utils.flop_counter import FlopCounterMode

    costs = _Costs()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, costs:
        fn(*args, **kwargs)
    seconds = time.perf_counter() - t0
    flops = float(fc.get_total_flops())
    return Counted(flops, float(costs.bytes_accessed), int(costs.peak),
                   dict(costs.off_meta), seconds)


# ---------------------------------------------------------------------------
# analytic collective counts of the sharded train step
# ---------------------------------------------------------------------------
def group_ranks(mesh, axes) -> list[int]:
    """The global ranks of rank 0's group along the mesh dimensions
    ``axes`` (row-major ranks over the mesh's shape)."""
    from repro_torch.launch.mesh import mesh_shape

    sizes = mesh_shape(mesh)
    names = list(sizes)
    strides = {a: math.prod(sizes[b] for b in names[i + 1:])
               for i, a in enumerate(names)}
    ranks = [0]
    for a in names:
        if a in axes:
            ranks = [r + j * strides[a] for r in ranks
                     for j in range(sizes[a])]
    return sorted(ranks)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def gather_collectives(cfg, mesh, dtype_bytes: int = 2) -> CollectiveStats:
    """The all-gathers that make every leaf whole on a rank from its
    block under ``train_step.param_layout`` (``distributed._gather_full``:
    one a split dimension, in dimension order), each element
    ``dtype_bytes`` wide (2: the bfloat16 copy a sharded step gathers)."""
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.train import train_step

    sizes = mesh_shape(mesh)
    with torch.device("meta"):
        from repro_torch.models import transformer
        shapes = {n: p.numel() for n, p in
                  transformer.Transformer(cfg).named_parameters()}
    stats = CollectiveStats()
    for name, spec in train_step.param_layout(cfg, mesh).items():
        split = [_entry_axes(e) for e in spec if _entry_axes(e)]
        b = shapes[name] * dtype_bytes // math.prod(
            math.prod(sizes[a] for a in axes) for axes in split)
        for axes in split:
            q = math.prod(sizes[a] for a in axes)
            stats.add("all-gather", b, q * b, group_ranks(mesh, axes))
            b *= q
    return stats


def train_collectives(cfg, mesh, global_batch: int,
                      microbatches: int = 1) -> CollectiveStats:
    """One rank's collectives in one sharded train step
    (``train_step.make_train_step(mesh=...)``) over ``mesh`` (a
    ``MeshSpec`` or ``DeviceMesh``), the global batch split by
    ``partition.batch_pspec``: the bfloat16 gathers
    (:func:`gather_collectives`); an all-to-all a leaf and microbatch
    summing the bfloat16 gradient blocks over the batch's mesh
    dimensions, and one for the (loss, aux) pair; one over the whole mesh
    for the grad norm's sum of squares; the failure agreement's
    all-reduce."""
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.models import transformer
    from repro_torch.sharding import partition
    from repro_torch.train import train_step

    sizes = mesh_shape(mesh)
    names = tuple(sizes)
    everyone = group_ranks(mesh, names)
    stats = gather_collectives(cfg, mesh)
    axes = _entry_axes(partition.batch_pspec(mesh, global_batch)[0])
    if axes:
        q = math.prod(sizes[a] for a in axes)
        ranks = group_ranks(mesh, axes)
        with torch.device("meta"):
            numel = {n: p.numel() for n, p in
                     transformer.Transformer(cfg).named_parameters()}
        layout = train_step.param_layout(cfg, mesh)
        for _ in range(microbatches):
            for name, spec in layout.items():
                split = math.prod(sizes[a] for e in spec
                                  for a in _entry_axes(e))
                stats.add("all-to-all", q * numel[name] * 2 // split,
                          q * numel[name] * 2 // split, ranks)
        stats.add("all-to-all", q * 8, q * 8, ranks)         # loss, aux
    p = len(everyone)
    stats.add("all-to-all", p * 4, p * 4, everyone)          # grad norm
    stats.add("all-reduce", 4, 4, everyone)                  # agreement
    return stats
