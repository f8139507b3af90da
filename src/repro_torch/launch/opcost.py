"""Per-device cost accounting of one call: the counterpart of the JAX
package's ``launch/hlocost.py``, which parses the compiled, partitioned
HLO.  There is no compiled program here; ``analyze(fn, *args)`` runs
the call once under a ``TorchDispatchMode`` and counts the **local**
operations each rank runs:

* DTensor operations are let through to DTensor, which runs them on
  this rank's local shards (and inserts the collectives of a
  redistribution); the mode counts those local operations.  Its own
  shape propagation (on fake tensors) is not counted.  So a
  (65536 x 16384) . (16384 x 53248) product sharded on a (16, 16) mesh
  counts this rank's (4096 x 1024) . (1024 x 53248) piece, where
  ``FlopCounterMode`` counts the global product;
* ``flops``: a matrix product 2*M*N*K (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``convolution``; ``matmul`` and ``einsum`` reach the
  mode as these); an elementwise operation one per output element and a
  transcendental one (counted in ``transcendentals`` too), as the
  classes of ``hlocost.py:28-50``; a reduction one per input element;
* ``traffic_bytes``: every operation that is not a view, a factory or
  a wait reads its tensor operands and writes its outputs once (no
  fusion: an upper bound of what a fused program would move);
* ``collective_bytes`` / ``collective_counts`` per type, as
  ``hlocost.py`` counts them over a group of g ranks: all-reduce
  2 (g-1)/g of its bytes, all-gather (g-1)/g of its output,
  reduce-scatter and all-to-all (g-1)/g of their input;
* ``peak_bytes``: the peak of the bytes held by storages the call
  allocated, alive at once (exact: see ``CostMode._track``).  This is
  the port's own measure of a call's temporaries, not XLA's buffer
  assignment.

The analog of the reference's loop-trip multiplication is the caller's:
a stack of identical layers (or a scan's identical steps) is counted at
two depths and extrapolated, ``c1 + (c2 - c1) * (n - 1)`` with
``OpCost.add`` (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "abs", "neg",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "logical_and",
    "logical_or", "logical_not", "logical_xor", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "clamp", "clamp_min",
    "clamp_max", "floor", "ceil", "round", "sign", "remainder", "fmod",
    "atan2", "relu", "threshold_backward", "masked_fill", "lerp",
    "_to_copy", "copy", "fill", "square", "reciprocal", "addcmul",
    "addcdiv",
}
_TRANSCENDENTAL = {
    "exp", "tanh", "log", "sigmoid", "rsqrt", "sqrt", "pow", "sin", "cos",
    "expm1", "log1p", "erf", "tan", "silu", "gelu", "softplus",
    "_softmax", "_log_softmax", "tanh_backward", "sigmoid_backward",
    "silu_backward", "softplus_backward", "_softmax_backward_data",
    "_log_softmax_backward_data",
}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "var", "std",
           "prod", "norm", "linalg_vector_norm", "cumsum", "argmax",
           "argmin", "logsumexp", "any", "all"}
# views, metadata and factories: no work and no traffic
_FREE = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "permute", "transpose", "t", "slice", "select", "unsqueeze",
    "squeeze", "as_strided", "alias", "detach", "split", "split_with_sizes",
    "chunk", "unbind", "view_as_real", "view_as_complex", "narrow",
    "unfold", "diagonal", "lift_fresh", "empty", "empty_like",
    "empty_strided", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "new_empty", "new_empty_strided", "new_zeros",
    "new_ones", "new_full", "arange", "scalar_tensor", "_local_scalar_dense",
    "wait_tensor", "_wrap_tensor_autograd", "set_", "resize_",
    "_has_compatible_shallow_copy_type", "is_same_size", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "_to_dense",
    "lift", "_assert_tensor_metadata", "detach_",
}
_DOTS = {"mm", "addmm", "bmm", "baddbmm"}
_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "all_reduce_coalesced": "all-reduce",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor_coalesced": "reduce-scatter"}


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    transcendentals: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    peak_bytes: float = 0.0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def add(self, other: "OpCost", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.transcendentals += other.transcendentals * mult
        self.traffic_bytes += other.traffic_bytes * mult
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] = self.collective_bytes.get(k, 0.0) + v * mult
        for k, v in other.collective_counts.items():
            self.collective_counts[k] = self.collective_counts.get(k, 0.0) + v * mult
        self.peak_bytes += other.peak_bytes * mult


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _tensors(x: Any) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _group_size(name: str, args: Tuple[Any, ...]) -> int:
    """Ranks in the collective's group: its ``group_size`` argument, or
    the size of the group its name resolves to."""
    for a in args[1:]:
        if isinstance(a, int) and not isinstance(a, bool):
            return a
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


def _dot_flops(op: str, args: Tuple[Any, ...], out: torch.Tensor) -> float:
    if op in ("mm", "bmm"):
        k = args[0].shape[-1]
    elif op in ("addmm", "baddbmm"):
        k = args[1].shape[-1]
    else:
        return 0.0
    return 2.0 * out.numel() * k


class CostMode(TorchDispatchMode):
    """Counts every local operation dispatched while it is active into
    ``cost`` (see the module's docstring)."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self._live: Dict[int, Tuple[Any, float]] = {}
        self._live_bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        from torch._subclasses.fake_tensor import FakeTensor
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out      # DTensor's shape propagation, not this rank's work
        self._count(func, args, ins, outs)
        return out

    def _count(self, func, args, ins: List[torch.Tensor],
               outs: List[torch.Tensor]) -> None:
        c = self.cost
        op = func.__name__.split(".")[0]
        ns = func.namespace
        if ns == "_c10d_functional" and op in _COLLECTIVES:
            kind = _COLLECTIVES[op]
            g = _group_size(op, args)
            ring = (g - 1) / max(g, 1)
            if kind == "all-reduce":
                b = sum(_nbytes(t) for t in outs) * 2 * ring
            elif kind == "all-gather":
                b = sum(_nbytes(t) for t in outs) * ring
            else:
                b = sum(_nbytes(t) for t in ins) * ring
            c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) + b
            c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1
            c.traffic_bytes += sum(_nbytes(t) for t in ins + outs)
            self._track(ins, outs)
            return
        base = op.rstrip("_")
        if base in _FREE or ns not in ("aten", "prims"):
            self._track(ins, outs)
            return
        n_out = float(sum(t.numel() for t in outs))
        if base in _DOTS:
            c.flops += _dot_flops(base, args, outs[0])
        elif base == "convolution":
            w = args[1]
            c.flops += 2.0 * n_out * math.prod(w.shape[1:])
        elif base in _TRANSCENDENTAL:
            c.flops += n_out
            c.transcendentals += n_out
        elif base in _REDUCE:
            c.flops += float(ins[0].numel()) if ins else 0.0
        elif base in _ELEMENTWISE:
            c.flops += n_out
        c.traffic_bytes += sum(_nbytes(t) for t in ins + outs)
        self._track(ins, outs)

    def _track(self, ins: List[torch.Tensor],
               outs: List[torch.Tensor]) -> None:
        """Add the storages an operation allocated (not its inputs':
        views and in-place results) to the live set.  The running sum
        counts storages that may have died since the last sweep, so it
        bounds the live bytes from above: only when it passes the peak
        is the set swept (linear in its size) for the exact count, and
        the peak raised.  So the peak is exact, and a scan's thousands of
        small steps below it cost no sweep."""
        from torch.multiprocessing.reductions import StorageWeakRef
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._live and key not in seen:
                n = float(st.nbytes())
                self._live[key] = (StorageWeakRef(st), n)
                self._live_bytes += n
        if self._live_bytes > self.cost.peak_bytes:
            self._sweep()

    def _sweep(self) -> None:
        dead = [k for k, (ref, _n) in self._live.items() if ref.expired()]
        for k in dead:
            self._live_bytes -= self._live.pop(k)[1]
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live_bytes)


def analyze(fn: Callable, *args: Any, **kwargs: Any) -> Tuple[OpCost, Any]:
    """(the per-device cost of one call ``fn(*args, **kwargs)``, its
    result)."""
    with CostMode() as mode:
        out = fn(*args, **kwargs)
    return mode.cost, out
