"""Tracing, profiling and speed-of-light accounting on the card.

Counterpart of ``blf_tpu/utils/profiling.py``, with its public names, in
PyTorch's idiom and in Hopper's units where the reference has the TPU's:

- :class:`ChipSpec`, :data:`CHIP_SPECS`, :func:`detect_chip`: the roofline
  ceilings of the card the code runs on (dense bf16 on the tensor cores,
  float32 on the CUDA cores, device memory), keyed by substrings of
  ``torch.cuda.get_device_name``; :func:`spec_for_name` is the match alone.
- :class:`KernelCost` and one cost model for each hand-written kernel of the
  port (:func:`admm_stage_cost` for K1 in its three modes and at every shape,
  :func:`admm_lane_cost` K2, :func:`cholesky_inverse_cost` K3,
  :func:`cholesky_solve_cost` K4, :func:`foot_rollout_cost` K5): work counted
  by hand from the kernel sources, which no operator-level counter sees.
- :func:`measure` and :func:`measure_chained`: timing harnesses, by CUDA
  events on CUDA tensors and by the host's clock on the CPU.
- :func:`cost_analysis`: a program's FLOPs (``FlopCounterMode``) and the
  bytes its aten operations read and write (a ``TorchDispatchMode``).
- :func:`roofline_seconds`, :func:`sol_score`, :func:`sol_report`: scoring a
  time against the roofline.
- :func:`trace`: the port's one span facility, opened at every layer
  boundary of the program; off, it costs a few hundred nanoseconds. Under
  ``torch.profiler`` a span is a ``record_function`` span (and an NVTX range
  once CUDA is up), on the clock of the device's activity; inside
  :func:`recording` it is also kept in memory with CUDA events at its ends
  (:class:`Recording`: rows, and a summary by name with self times).

``python -m blf_tpu_torch.utils.profiling`` prints a speed-of-light table of
the port's hot programs on the card (:func:`sol_rows`, :func:`main`).

Not ported: the TPU's padding of operands to 8 x 128 tiles and its vector
unit's issue-rate ceiling; the reference's ``measure_chained`` scans inside
one jit, a workaround for its host tunnel that has no counterpart here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from blf_tpu_torch.utils.containers import tree_leaves
from blf_tpu_torch.utils.device import resolve_device

__all__ = [
    "ChipSpec",
    "CHIP_SPECS",
    "detect_chip",
    "spec_for_name",
    "measure",
    "measure_chained",
    "cost_analysis",
    "roofline_seconds",
    "sol_report",
    "sol_score",
    "trace",
    "recording",
    "Recording",
    "SpanRow",
    "KernelCost",
    "admm_stage_cost",
    "admm_lane_cost",
    "cholesky_inverse_cost",
    "cholesky_solve_cost",
    "foot_rollout_cost",
    "FOOT_OPS_PER_LANE_STEP",
    "sol_rows",
]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Roofline ceilings of one card, from NVIDIA's data sheets at the card's
    full power limit (a card set lower runs slower under load).

    ``peak_flops_bf16``: FLOP/s of the tensor cores in bf16, dense (no
    sparsity). ``peak_flops_f32``: FLOP/s of float32 on the CUDA cores, an
    FMA counted as two. ``hbm_bytes_per_s``: bytes/s of device memory.
    """

    name: str
    peak_flops_bf16: float
    peak_flops_f32: float
    hbm_bytes_per_s: float

    def peak_flops(self, dtype: str = "f32") -> float:
        return self.peak_flops_bf16 if dtype == "bf16" else self.peak_flops_f32


CHIP_SPECS: Dict[str, ChipSpec] = {
    # keyed by lower-case substrings of torch.cuda.get_device_name; each H100
    # by its own name, so a variant not listed (NVL, 94 GB parts) is refused
    "h100 80gb hbm3": ChipSpec("H100 SXM", 989e12, 67e12, 3.35e12),
    "h100 pcie": ChipSpec("H100 PCIe", 756e12, 51e12, 2.0e12),
    # the host, for a run on CPU tensors: rough single-socket numbers, only
    # for relative comparisons (the reference's entry)
    "cpu": ChipSpec("host CPU", 1e12, 5e11, 5e10),
}


def spec_for_name(kind: str) -> ChipSpec:
    """The :class:`ChipSpec` whose key is the longest substring of ``kind``
    (case aside), so "NVIDIA H100 PCIe" is not taken for the SXM card.

    Raises ``LookupError`` for a name no key matches: a card scored against
    another card's ceilings would report false fractions.
    """
    kind = kind.lower()
    keys = [key for key in CHIP_SPECS if key in kind]
    if not keys:
        raise LookupError(f"no ChipSpec matches {kind!r}; known: {sorted(CHIP_SPECS)}")
    return CHIP_SPECS[max(keys, key=len)]


def detect_chip(device=None) -> ChipSpec:
    """The :class:`ChipSpec` of ``device``: ``None`` is the current GPU (and
    raises without one, as every entry point of the port does), ``"cpu"``
    the host's entry."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return CHIP_SPECS["cpu"]
    if dev.type != "cuda":
        raise ValueError(f"detect_chip takes a cpu or cuda device, not {dev}")
    return spec_for_name(torch.cuda.get_device_name(dev))


# ---------------------------------------------------------------------------
# Hand-counted cost models of the port's kernels.
#
# An operator-level counter sees no work inside a hand-written kernel (nor
# does XLA's cost model inside a ``pallas_call``), so each kernel's work is
# counted from its source, in the units of the card:
#
# - ``useful_flops``: the algorithm's work, the same whatever implements it
#   (a perfect machine's count, with no passes and no padding);
# - ``tensor_flops``: what the tensor cores execute in bf16, every pass of a
#   split product included;
# - ``fma_flops``: float32 work on the CUDA cores, elementwise work included,
#   an FMA two;
# - ``bytes``: each input read once and each output written once.
#
# ``sol_seconds`` is the largest of the three times at the card's peaks.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Hand-counted cost of one kernel launch (see the block comment)."""

    useful_flops: float
    tensor_flops: float
    fma_flops: float
    bytes: float

    def unit_seconds(self, spec: ChipSpec) -> Dict[str, float]:
        """Seconds of each unit's work at its peak: ``tensor``, ``fma``,
        ``memory`` (0 where the spec has no such unit)."""
        rate = lambda work, peak: work / peak if peak else 0.0
        return {"tensor": rate(self.tensor_flops, spec.peak_flops_bf16),
                "fma": rate(self.fma_flops, spec.peak_flops_f32),
                "memory": rate(self.bytes, spec.hbm_bytes_per_s)}

    def sol_seconds(self, spec: ChipSpec) -> float:
        """Speed of light: the largest of the three unit bounds."""
        return max(self.unit_seconds(spec).values())


_STAGE_MODES = ("f32", "split", "delta")


def admm_stage_cost(B: int, m: int, n: int, iters: int,
                    matmul: str = "delta", dtype_bytes: int = 4) -> KernelCost:
    """One launch of :func:`blf_tpu_torch.ops.cuda.admm.admm_stage`, K1, at
    ``B`` lanes, operator ``(m, n)`` and ``iters`` iterations; the same model
    for the resident kernels and those that stream the operator from L2.

    Every iteration makes two products, ``w G2`` and ``tau G2^T``, of
    ``2 m n B`` FLOPs each: the useful work ``2 * 2 m n B iters`` in every
    mode (the reference's count).

    - ``"f32"`` (``csrc/admm_stage.cu``, ``admm_stage_l2.cu``) runs them on
      the FMA units: ``fma_flops`` are the products alone.
    - ``"split"`` and ``"delta"`` (``csrc/admm_stage_tc.cu``,
      ``admm_stage_tc_l2.cu``) run them on the tensor cores in passes of
      ``2 m n B``: 3 a product in every iteration of ``"split"`` and in the
      first of ``"delta"``, 2 after. Their float32 elementwise work, counted
      from ``admm_stage_tc.cu``: an element of v, clip 9, w 2, its split 4 or
      its increment 2, the update 12; of tau 2, and its split 4 or increment
      2; 5 an element of tau for the stage's gains.

    Bytes: v, l, u (m), tau and gq (n), s (1) read; v and tau written; the
    operator G2 (m n), d (n) and rho (m) read once.
    """
    if matmul not in _STAGE_MODES:
        raise ValueError(f"unknown matmul mode {matmul!r}; expected one of {_STAGE_MODES}")
    useful = 2.0 * 2.0 * B * m * n * iters
    nbytes = float(dtype_bytes * (B * ((3 * m + 2 * n + 1) + (m + n)) + m * n + m + n))
    if matmul == "f32":
        return KernelCost(useful, 0.0, useful, nbytes)
    passes = 2 * (3 * iters if matmul == "split" else 3 + 2 * (iters - 1))
    first = 27 * m + 6 * n
    later = first if matmul == "split" else 25 * m + 4 * n
    ops = B * (first + (iters - 1) * later + 5 * n)
    return KernelCost(useful, float(passes * 2 * m * n * B), float(ops), nbytes)


def admm_lane_cost(B: int, m: int, n: int, iters: int, dtype_bytes: int = 4) -> KernelCost:
    """One launch of :func:`blf_tpu_torch.ops.cuda.admm_lane.admm_lane_stage`,
    K2 (``csrc/admm_lane.cu``): ``iters`` iterations of a lane's own A (m, n)
    and K^-1 (n, n), each ``A^T w``, ``K^-1 r`` and ``A x`` (``2 (2 m n +
    n^2)`` FLOPs a lane) on the FMA units. Bytes: A and K^-1, the five
    m-vectors in and out and the two n-vectors, a lane."""
    flops = float(iters * 2 * (2 * m * n + n * n) * B)
    nbytes = float(dtype_bytes * B * (m * n + n * n + 5 * m + 2 * n))
    return KernelCost(flops, 0.0, flops, nbytes)


def cholesky_inverse_cost(B: int, n: int, dtype_bytes: int = 4) -> KernelCost:
    """One launch of :func:`blf_tpu_torch.ops.cuda.linalg.cholesky_inverse_lane`,
    K3 (``csrc/chol_lane.cu``): ``n^3 / 3`` FLOPs each for the factor, ``L^-1``
    and ``L^-T L^-1``, a matrix; one matrix read and one written."""
    flops = float(B * n ** 3)
    return KernelCost(flops, 0.0, flops, float(dtype_bytes * B * 2 * n * n))


def cholesky_solve_cost(B: int, n: int, dtype_bytes: int = 4) -> KernelCost:
    """One launch of :func:`blf_tpu_torch.ops.cuda.linalg.cholesky_solve_lane`,
    K4 (``csrc/chol_solve.cu``): the factor (``n^3 / 3``) and two triangular
    solves (``n^2`` each) a matrix; the matrix and b read, x written."""
    flops = B * (n ** 3 / 3 + 2 * n * n)
    return KernelCost(flops, 0.0, flops, float(dtype_bytes * B * (n * n + 2 * n)))


#: operations of one lane-step of ``csrc/foot_rollout.cu``, counted from its
#: source: a multiply, an add or subtract, an |.| and a division one each (an
#: FMA two), 7 divisions among them
FOOT_OPS_PER_LANE_STEP = 376


def foot_rollout_cost(B: int, steps: int, dtype_bytes: int = 4,
                      operand_floats: Optional[int] = None) -> KernelCost:
    """One launch of :func:`blf_tpu_torch.ops.cuda.rollout.foot_rollout_fused`,
    K5: ``steps`` Euler steps of ``B`` feet, all on the FMA units.

    :data:`FOOT_OPS_PER_LANE_STEP` (376) is counted from ``csrc/foot_rollout.cu``;
    the reference counts some 360 a lane-step from its own kernel body
    (``blf_tpu/utils/profiling.py:194``). Every operation is useful work.
    Bytes: the state's 18 floats a lane read and written once, and the
    ``operand_floats`` the kernel reads of the null pose, the contact
    coefficients and the 8 scalars (by default one pose and one (k, b) for
    all lanes; pass the count where they are per lane).
    """
    ops = float(FOOT_OPS_PER_LANE_STEP * B * steps)
    if operand_floats is None:
        operand_floats = 12 + 2 + 8
    return KernelCost(ops, 0.0, ops, float(dtype_bytes * (2 * 18 * B + operand_floats)))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def _cuda_device(*trees) -> Optional[torch.device]:
    """The device of the first CUDA tensor among the trees' leaves, if any."""
    for tree in trees:
        for leaf in tree_leaves(tree):
            if torch.is_tensor(leaf) and leaf.is_cuda:
                return leaf.device
    return None


def _seconds(run: Callable[[], Any], device: Optional[torch.device]) -> float:
    """Seconds ``run()`` takes: between two CUDA events on ``device``'s
    current stream, the second one waited for; on the host's clock when
    ``device`` is None (CPU tensors compute before they return)."""
    if device is None:
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) * 1e-3


def measure(
    fn: Callable[..., Any],
    *args: Any,
    warmup: int = 2,
    repeats: int = 5,
    inner: int = 1,
    reduce: str = "median",
) -> float:
    """Seconds of one call of ``fn(*args)``: the median of ``repeats``
    samples (the least with ``reduce="min"``), each timing ``inner`` calls
    back to back after ``warmup`` calls that absorb kernel builds and caches.

    Where an argument or the result holds a CUDA tensor, a sample is the
    time between two CUDA events around the calls, the second one waited
    for; otherwise the host's clock.
    """
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    device = _cuda_device(args, out)
    inner = max(inner, 1)

    def run():
        for _ in range(inner):
            fn(*args)

    samples = sorted(_seconds(run, device) / inner for _ in range(max(repeats, 1)))
    if reduce == "min":
        return samples[0]
    return samples[len(samples) // 2]


def measure_chained(
    step: Callable[[Any], Any],
    init: Any,
    *,
    ticks: int = 10,
    warmup: int = 1,
    repeats: int = 3,
) -> float:
    """Seconds per application of ``step`` (carry -> carry), chained: the
    best of ``repeats`` chains of ``ticks`` data-dependent applications from
    ``init``, each taking the previous output, timed as one.

    On CUDA tensors a chain is one pair of events with no synchronization
    between ticks, so the host's dispatch of a tick overlaps the device's
    work on the one before, as in the port's eager programs: a chain
    measures the slower of the two. (The reference scans the chain inside
    one jit to get past its host tunnel; that has no counterpart here.)
    """
    def chain(c):
        for _ in range(ticks):
            c = step(c)
        return c

    out = chain(init)
    for _ in range(max(warmup - 1, 0)):
        out = chain(out)
    device = _cuda_device(init, out)
    best = min(_seconds(lambda: chain(init), device) for _ in range(max(repeats, 1)))
    return best / ticks


# ---------------------------------------------------------------------------
# counting and scoring
# ---------------------------------------------------------------------------


_aten = torch.ops.aten
#: operations that move no bytes though their schemas are not views'
_NO_TRAFFIC = (_aten._unsafe_view, _aten.empty, _aten.empty_like, _aten.empty_strided,
               _aten.new_empty, _aten.new_empty_strided)


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten operation's tensor inputs and outputs;
    views and allocations move nothing and count nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.overloadpacket in _NO_TRAFFIC):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves([list(args), kwargs or {}, out])
                              if torch.is_tensor(t))
        return out


def cost_analysis(fn: Callable[..., Any], *args: Any) -> Dict[str, float]:
    """FLOPs and bytes of one call of ``fn(*args)``, which this runs.

    ``{"flops": ..., "bytes": ...}``: FLOPs as ``torch.utils.flop_counter``
    counts them (matrix products, convolutions, attention: elementwise work
    counts none), bytes as every aten operation's tensor inputs and outputs
    add up, views excluded. As in the reference, 0 means unknown, not free:
    a hand-written kernel is no aten operation and counts 0 here, as a
    ``pallas_call`` does in XLA's model. Score such a kernel by its
    :class:`KernelCost` (``sol_score(..., kernel_cost=...)``).
    """
    counter = _ByteCounter()
    with FlopCounterMode(display=False) as flops, counter:
        fn(*args)
    return {"flops": float(flops.get_total_flops()), "bytes": float(counter.bytes)}


def roofline_seconds(flops: float, nbytes: float, spec: ChipSpec,
                     dtype: str = "f32") -> float:
    """Speed-of-light time: the larger of the compute and memory bounds."""
    peak = spec.peak_flops(dtype)
    return max(flops / peak if peak else 0.0,
               nbytes / spec.hbm_bytes_per_s if spec.hbm_bytes_per_s else 0.0)


def sol_score(
    time_s: float,
    *,
    label: str = "program",
    dtype: str = "f32",
    spec: Optional[ChipSpec] = None,
    kernel_cost: Optional[KernelCost] = None,
    flops: float = 0.0,
    nbytes: float = 0.0,
) -> Dict[str, Any]:
    """Score a measured time against the card's roofline (``spec`` defaults
    to the current GPU's).

    With ``kernel_cost`` the bound is the largest of the tensor-core, FMA
    and memory bounds, named in ``bound`` (``"tensor"``, ``"fma"`` or
    ``"memory"``), and the report adds ``tensor_core_util``: useful FLOPs /
    time / bf16 peak. Otherwise pass ``flops``/``nbytes`` (see
    :func:`cost_analysis`); ``bound`` is then ``"compute"``, ``"memory"`` or
    ``"unknown"``, as in the reference.
    """
    spec = spec or detect_chip()
    if kernel_cost is not None:
        times = kernel_cost.unit_seconds(spec)
        bound = max(times, key=times.get)
        sol_t = times[bound]
        return {
            "label": label,
            "chip": spec.name,
            "dtype": dtype,
            "time_s": time_s,
            "flops": kernel_cost.useful_flops,
            "bytes": kernel_cost.bytes,
            "achieved_tflops": kernel_cost.useful_flops / time_s / 1e12,
            "achieved_gbps": kernel_cost.bytes / time_s / 1e9,
            "sol_time_s": sol_t,
            "sol_frac": (sol_t / time_s) if sol_t > 0 else 0.0,
            "tensor_core_util": (kernel_cost.useful_flops / time_s / spec.peak_flops_bf16
                                 if spec.peak_flops_bf16 else 0.0),
            "bound": bound,
        }
    sol_t = roofline_seconds(flops, nbytes, spec, dtype)
    compute_t = flops / spec.peak_flops(dtype)
    memory_t = nbytes / spec.hbm_bytes_per_s if spec.hbm_bytes_per_s else 0.0
    if flops == 0.0 and nbytes == 0.0:
        bound = "unknown"
    else:
        bound = "compute" if compute_t >= memory_t else "memory"
    return {
        "label": label,
        "chip": spec.name,
        "dtype": dtype,
        "time_s": time_s,
        "flops": flops,
        "bytes": nbytes,
        "achieved_tflops": flops / time_s / 1e12,
        "achieved_gbps": nbytes / time_s / 1e9,
        "sol_time_s": sol_t,
        "sol_frac": (sol_t / time_s) if sol_t > 0 else 0.0,
        "bound": bound,
    }


def sol_report(
    fn: Callable[..., Any],
    *args: Any,
    label: str = "program",
    dtype: str = "f32",
    spec: Optional[ChipSpec] = None,
    warmup: int = 2,
    repeats: int = 5,
    inner: int = 1,
    kernel_cost: Optional[KernelCost] = None,
) -> Dict[str, Any]:
    """Measure ``fn(*args)`` (:func:`measure`) and score it (:func:`sol_score`).

    The FLOPs and bytes come from :func:`cost_analysis`, unless a
    ``kernel_cost`` is given: a hand-written kernel counts 0 there. ``spec``
    defaults to the device of the first tensor among ``args`` (the current
    GPU when there is none).
    """
    if spec is None:
        tensors = [t for t in tree_leaves(list(args)) if torch.is_tensor(t)]
        spec = detect_chip(tensors[0].device if tensors else None)
    t = measure(fn, *args, warmup=warmup, repeats=repeats, inner=inner)
    if kernel_cost is not None:
        return sol_score(t, label=label, dtype=dtype, spec=spec, kernel_cost=kernel_cost)
    cost = cost_analysis(fn, *args)
    return sol_score(t, label=label, dtype=dtype, spec=spec,
                     flops=cost["flops"], nbytes=cost["bytes"])


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class SpanRow(NamedTuple):
    """One span kept by a :func:`recording`. Times are nanoseconds on the
    host's ``time.perf_counter_ns`` clock; the device's are put on it through
    the recording's anchor (None where the recording has no CUDA events)."""

    id: int
    parent: Optional[int]      # the id of the span it opened inside
    unit: int                  # the sequence number of its root span
    name: str
    host_start_ns: int
    host_end_ns: int
    device_start_ns: Optional[float]
    device_end_ns: Optional[float]


class Recording:
    """The spans opened while a :func:`recording` is open, kept as they open
    and close (CUDA events unread) and resolved only by :meth:`rows` or
    :meth:`summary`, after the work. Their nesting is one thread's: spans
    that other threads open meanwhile would interleave with it."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self._spans: List[list] = []   # [name, parent, unit, host0, host1, event0, event1]
        self._open: List[int] = []
        self._roots = 0
        if cuda:
            # the anchor: the device's clock is read against the host's at one point
            torch.cuda.synchronize()
            self._anchor = torch.cuda.Event(enable_timing=True)
            self._anchor.record()
            self._anchor_ns = time.perf_counter_ns()

    def _event(self):
        if not self.cuda:
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def _enter(self, name: str) -> int:
        if self._open:
            parent = self._open[-1]
            unit = self._spans[parent][2]
        else:
            parent, unit = None, self._roots
            self._roots += 1
        i = len(self._spans)
        self._spans.append([name, parent, unit, time.perf_counter_ns(), None, self._event(), None])
        self._open.append(i)
        return i

    def _exit(self, i: int) -> None:
        span = self._spans[i]
        span[6] = self._event()
        span[4] = time.perf_counter_ns()
        self._open.remove(i)

    def rows(self) -> List[SpanRow]:
        """Every closed span, in the order they opened; waits for the device."""
        if self.cuda:
            torch.cuda.synchronize()
        on_host = lambda e: self._anchor_ns + 1e6 * self._anchor.elapsed_time(e)
        return [SpanRow(i, parent, unit, name, h0, h1,
                        on_host(e0) if self.cuda else None, on_host(e1) if self.cuda else None)
                for i, (name, parent, unit, h0, h1, e0, e1) in enumerate(self._spans)
                if h1 is not None]

    def summary(self) -> Dict[str, Dict[str, Any]]:
        """Per span name: ``count``, ``host_ms`` and ``device_ms`` (summed
        durations; ``device_ms`` None without CUDA events), and ``self_ms``:
        the spans' duration less the part their child spans cover, on the
        device's clock where the recording has it, else on the host's. The
        self times of all names add up to the root spans' time."""
        rows = self.rows()
        dur = lambda r: ((r.device_end_ns - r.device_start_ns) if self.cuda
                         else (r.host_end_ns - r.host_start_ns))
        children = {r.id: 0.0 for r in rows}
        for r in rows:
            if r.parent in children:
                children[r.parent] += dur(r)
        out: Dict[str, Dict[str, Any]] = {}
        for r in rows:
            s = out.setdefault(r.name, {"count": 0, "host_ms": 0.0,
                                        "device_ms": 0.0 if self.cuda else None,
                                        "self_ms": 0.0})
            s["count"] += 1
            s["host_ms"] += 1e-6 * (r.host_end_ns - r.host_start_ns)
            if self.cuda:
                s["device_ms"] += 1e-6 * (r.device_end_ns - r.device_start_ns)
            s["self_ms"] += 1e-6 * (dur(r) - children[r.id])
        return out


#: the open recording's log, or None
_recording: Optional[Recording] = None
_profiler_enabled = torch.autograd._profiler_enabled


@contextlib.contextmanager
def recording():
    """Keep the spans that :func:`trace` opens inside the block, without the
    profiler: ``with recording() as log: ...``, then ``log.rows()`` or
    ``log.summary()``. Each span is marked by ``time.perf_counter_ns`` at both
    ends and, once CUDA is initialized, by a CUDA event on the current stream
    at both ends. One recording at a time."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a recording is already open")
    log = Recording(torch.cuda.is_initialized())
    _recording = log
    try:
        yield log
    finally:
        _recording = None


class _Off:
    """The span :func:`trace` returns while nothing records: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_OFF = _Off()


class _Span:
    """A span while the profiler or a recording is on."""

    __slots__ = ("name", "_function", "_nvtx", "_log", "_row")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._function = None
        if _profiler_enabled():
            self._function = torch.profiler.record_function(self.name)
            self._function.__enter__()
        self._nvtx = torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._log = _recording
        self._row = self._log._enter(self.name) if self._log is not None else None
        return self

    def __exit__(self, *exc):
        if self._log is not None:
            self._log._exit(self._row)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._function is not None:
            self._function.__exit__(*exc)
        return None


def trace(name: str):
    """A span named ``name`` around a region: ``with trace("qp.stage"): ...``.

    Off, that is with no ``torch.profiler`` active and no :func:`recording`
    open, it returns one shared object that does nothing: no
    ``record_function``, no NVTX range, no CUDA event. On, the span is a
    ``torch.profiler.record_function`` span, which the profiler timestamps on
    the clock of the device's activity, so every device operation and idle
    gap can be assigned to the innermost span open on the host; an NVTX range
    once CUDA is initialized; and inside a :func:`recording`, a row of its
    log. Where the work runs does not change."""
    if _recording is None and not _profiler_enabled():
        return _OFF
    return _Span(name)


# ---------------------------------------------------------------------------
# the speed-of-light table
# ---------------------------------------------------------------------------


def sol_rows(device=None, *, batch: int = 98304,
             foot_batch: int = 16384) -> List[Dict[str, Any]]:
    """The speed-of-light rows of the port's hot programs on ``device`` (the
    GPU by default), at the reference's sizes (``blf_tpu/utils/profiling.py``,
    ``main``), each timed by :func:`measure_chained`:

    - ``qp.factor_shared (1x)`` at horizon 16, by :func:`cost_analysis`;
    - at horizons 16 and 32, the DCM QP's stage kernel K1 for 50 iterations
      in one launch on ``batch`` lanes in modes ``f32`` (the port's fleet
      tick), ``delta`` and ``split``, by :func:`admm_stage_cost`; and
      ``qp.solve_factored[cuda_delta]`` (the reference's ``"pallas"``, its
      stages of 25 iterations and their boundaries), by the kernel's cost;
    - the foot rollout of ``foot_batch`` lanes over 200 steps on
      ``backend="torch"`` (by :func:`cost_analysis`) and ``"cuda"`` (K5, by
      :func:`foot_rollout_cost`).

    The lane counts are options for a rehearsal on CPU tensors, where
    ``"cuda"`` runs the kernels' plain versions.
    """
    from blf_tpu_torch.models.foot import foot_rollout
    from blf_tpu_torch.models.lipm import LIPMParams
    from blf_tpu_torch.mpc.dcm import build_dcm_qp
    from blf_tpu_torch.mpc.qp import factor_shared_qp, solve_qp_factored
    from blf_tpu_torch.ops.cuda.admm import admm_stage
    from blf_tpu_torch.ops.cuda.rollout import rollout_operands
    from blf_tpu_torch.problems import foot_drop_fleet

    horizons, iters, foot_steps, seed = (16, 32), 50, 200, 0
    dev = resolve_device(device)
    spec = detect_chip(dev)
    dtype = torch.float32
    new = dict(dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    normal = lambda *shape: 0.01 * torch.randn(shape, generator=gen, **new)
    rows = []

    for horizon in horizons:
        params = LIPMParams(torch.tensor(0.9, **new), torch.tensor(9.81, **new))
        poly_A = torch.tensor([[1.0, 0], [-1.0, 0], [0, 1.0], [0, -1.0]], **new)
        P, q, A, l, u = build_dcm_qp(
            params, 0.1, torch.zeros(2, **new), torch.zeros((horizon + 1, 2), **new),
            torch.zeros((horizon, 2), **new), poly_A.expand(horizon, 4, 2),
            torch.tensor([0.1, 0.1, 0.06, 0.06], **new).expand(horizon, 4))
        n, m = P.shape[0], A.shape[0]
        is_eq = torch.arange(m, device=dev) < 2 * horizon
        factors = factor_shared_qp(P, A, is_eq)

        if horizon == horizons[0]:   # the reference factors once, at horizon 16
            factor = lambda Pm: factor_shared_qp(Pm, A, is_eq)
            ca = cost_analysis(factor, P)
            t = measure_chained(lambda Pm: factor(Pm).P_s * 0 + Pm, P, ticks=4)
            rows.append(sol_score(t, label="qp.factor_shared (1x)", spec=spec,
                                  flops=ca["flops"], nbytes=ca["bytes"]))

        # K1, one launch of `iters` iterations a tick, lane-major (B, .)
        v0, tau0 = normal(batch, m), torch.zeros((batch, n), **new)
        s = torch.ones((batch, 1), **new)
        gq = normal(batch, n)
        l_b, u_b = l.expand(batch, m).contiguous(), u.expand(batch, m).contiguous()
        for mode in ("f32", "delta", "split"):
            step = lambda c, mode=mode: admm_stage(
                c[0], c[1], s, gq, l_b, u_b, factors.G2, factors.d, factors.base_rho,
                iters=iters, alpha=1.6, matmul=mode)
            t = measure_chained(step, (v0, tau0), ticks=10)
            rows.append(sol_score(
                t, label=f"admm_stage[{mode}] h={horizon} B={batch}", spec=spec,
                kernel_cost=admm_stage_cost(batch, m, n, iters, mode)))

        # the whole factored solve: its stage boundaries and diagnostics are
        # the gap to the kernel's row, which gives the numerator
        def solve_step(qq):
            sol = solve_qp_factored(factors, qq, l, u, iterations=iters, backend="cuda_delta")
            return qq + 1e-30 * sol.x

        t = measure_chained(solve_step, q + normal(batch, n), ticks=10)
        rows.append(sol_score(
            t, label=f"qp.solve_factored[cuda_delta] h={horizon} B={batch}", spec=spec,
            kernel_cost=admm_stage_cost(batch, m, n, iters, "delta")))

    fleet = foot_drop_fleet(foot_batch, seed=seed, device=dev, dtype=dtype)
    for backend in ("torch", "cuda"):
        step = lambda st, backend=backend: foot_rollout(
            fleet.cparams, fleet.fparams, st, fleet.null_position, fleet.null_rotation,
            dt=fleet.dt, steps=foot_steps, backend=backend)
        t = measure_chained(step, fleet.state, ticks=5)
        label = f"foot_rollout[{backend}] (B={foot_batch})"
        if backend == "torch":
            ca = cost_analysis(step, fleet.state)
            rows.append(sol_score(t, label=label, spec=spec,
                                  flops=ca["flops"], nbytes=ca["bytes"]))
        else:
            operands = rollout_operands(fleet.cparams, fleet.fparams, fleet.state,
                                        fleet.null_position, fleet.null_rotation, fleet.dt)[4:9]
            cost = foot_rollout_cost(foot_batch, foot_steps,
                                     operand_floats=sum(x.numel() for x in operands))
            rows.append(sol_score(t, label=label, spec=spec, kernel_cost=cost))
    return rows


def _format_row(r: Dict[str, Any]) -> str:
    """One row of the table as text."""
    util = (f" TC {100.0 * r['tensor_core_util']:>5.1f}%" if "tensor_core_util" in r else "")
    return (f"{r['label']:<44} {r['time_s'] * 1e3:>9.3f} ms "
            f"{r['achieved_tflops']:>8.2f} TF/s {r['achieved_gbps']:>8.1f} GB/s "
            f"SOL {100.0 * r['sol_frac']:>5.1f}%{util} ({r['bound']})")


def main() -> None:  # pragma: no cover - runs on the card
    """Print the speed-of-light table of :func:`sol_rows` on the current GPU,
    after a line with the detected :class:`ChipSpec` and ``nvidia-smi``'s
    name and power limit."""
    spec = detect_chip()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"chip: {spec.name}  peak {spec.peak_flops_bf16 / 1e12:.0f} TF/s bf16, "
          f"{spec.peak_flops_f32 / 1e12:.0f} TF/s f32, "
          f"{spec.hbm_bytes_per_s / 1e9:.0f} GB/s  [nvidia-smi: {smi}]", flush=True)
    for r in sol_rows():
        print(_format_row(r), flush=True)


if __name__ == "__main__":  # pragma: no cover
    main()
