"""Work counted per aten op as it is dispatched: FLOPs, bytes,
transcendentals.

Twin of src/repro/launch/hlo_cost.py. The port has no HLO: it runs
eagerly, so `analyze(fn, *args)` runs `fn` under a TorchDispatchMode and
counts each aten op that reaches the backend, forward and backward alike,
on "meta", CPU or CUDA tensors (the counts depend on shapes only, so a
program on meta tensors costs what it costs on the card, with no
allocation).

Counting follows the reference's conventions (hlo_cost.py's
`_instr_cost`):

  flops            dot/convolution: 2 per multiply-accumulate, for every
                   op of the matmul family (`mm`, `bmm`, `addmm`,
                   `baddbmm`, `addbmm`, `addmv`, `mv`, `dot`, `vdot`,
                   `convolution` and its backward), which is what
                   `einsum`, `matmul` and `linear` lower to; pointwise
                   arithmetic (add, multiply, compare, select, ...): 1
                   per output element; reductions: 1 per reduced input
                   element.
  transcendentals  exp, log, tanh, logistic, rsqrt, sqrt, power, sin,
                   cos, erf, expm1, log1p, cbrt: 1 per output element,
                   counted here and not under flops. A fused aten op
                   counts what the reference's lowering of the same
                   function counts (softmax: max, subtract, exp, sum,
                   divide; silu: logistic and multiply; ...).
  bytes            operand bytes plus output bytes of every op that runs a
                   kernel (views move nothing). Eager mode fuses nothing,
                   so this is an upper bound on the reference's bytes,
                   which it counts at XLA's fusion boundaries; the two
                   byte counts are not comparable as equal.

The reference's `while_trips`, `unknown_trip_loops` and
`collective_bytes` have no counterpart: eager mode runs every loop
iteration, so a loop of L layers counts L times one layer with no trip
weighting (remat's recompute is counted because its ops run, as the
reference's HLO counts it), and one card runs no collective.

Not seen: the four CUDA kernels of `kernels/csrc/` are launched through
ctypes, not aten, so their work is not counted (chip_smoke's `kernels`
line bounds each of them).

`analyze` returns {"flops", "bytes", "transcendentals", "by_op"}, where
`by_op` maps the name of each aten op that runs a kernel (not a view) to
its {"count", "flops", "bytes", "transcendentals"}.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "addmv", "mv", "dot",
           "vdot", "_addmm_activation"}

_TRANSCENDENTAL = {"exp", "exp2", "log", "log2", "log10", "tanh", "rsqrt",
                   "sqrt", "pow", "float_power", "sin", "cos",
                   "tan", "erf", "erfc", "erfinv", "expm1", "log1p", "asin",
                   "acos", "atan", "sinh", "cosh", "asinh", "acosh", "atanh",
                   "reciprocal_sqrt", "lgamma", "digamma"}

_POINTWISE = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "maximum",
              "minimum", "max_other", "min_other", "clamp", "clamp_min",
              "clamp_max", "clip", "where", "eq", "ne", "lt", "le", "gt",
              "ge", "logical_and", "logical_or", "logical_xor",
              "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
              "bitwise_not", "bitwise_left_shift", "bitwise_right_shift",
              "floor", "ceil", "round", "trunc",
              "remainder", "fmod", "atan2", "sign", "masked_fill",
              "reciprocal", "square", "fmax", "fmin", "floor_divide",
              "lerp", "addcmul", "addcdiv",
              "heaviside", "nan_to_num", "isnan", "isinf", "isfinite",
              "copysign", "frac", "signbit"}

_REDUCTION = {"sum", "mean", "amax", "amin", "max", "min", "prod", "any",
              "all", "argmax", "argmin", "logsumexp", "norm",
              "linalg_vector_norm", "var", "std", "var_mean", "std_mean",
              "nansum", "count_nonzero"}

#: (flops, transcendentals) per output element of the fused aten ops,
#: as the reference counts their JAX lowering on the CPU backend, which
#: expands logistic(x) into 1 / (1 + exp(-x)): sigmoid = negate, exp,
#: add, divide; silu = x * sigmoid(x); softplus = logaddexp(x, 0);
#: log_sigmoid = -softplus(-x); gelu = the tanh approximation. The
#: backward ops count the arithmetic of their derivative.
_FUSED = {
    "sigmoid": (3, 1),
    "silu": (4, 1),
    "softplus": (6, 2),
    "log_sigmoid_forward": (8, 2),
    "gelu": (8, 1),
    "relu": (1, 0),
    "hardtanh": (2, 0),
    "sigmoid_backward": (3, 0),  # g * y * (1 - y)
    "tanh_backward": (3, 0),  # g * (1 - y * y)
    "silu_backward": (7, 1),  # g * s * (1 + x * (1 - s))
    "softplus_backward": (4, 1),  # g * sigmoid(x)
    "log_sigmoid_backward": (5, 1),  # g * sigmoid(-x)
    "gelu_backward": (14, 1),
    "threshold_backward": (1, 0),
    "_softmax": (4, 1),  # max, subtract, exp, sum, divide
    "_log_softmax": (4, 2),  # max, subtract, exp, sum, log, subtract
    "_softmax_backward_data": (4, 0),  # y * (g - sum(g * y))
    "_log_softmax_backward_data": (4, 1),  # g - exp(y) * sum(g)
}

#: ops that alias, re-describe or only allocate: no kernel, no bytes
#: (names as `_kind` reads them: an in-place op's trailing "_" dropped)
_NO_KERNEL = {"view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
              "expand_as", "permute", "transpose", "t", "slice", "select",
              "squeeze", "unsqueeze", "as_strided", "alias", "detach",
              "split", "split_with_sizes", "chunk", "unbind", "narrow",
              "view_as", "unfold", "diagonal", "movedim", "lift_fresh",
              "empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "set", "resize", "real", "imag",
              "view_as_real", "view_as_complex", "_local_scalar_dense"}


def flat_tensors(tree) -> list:
    """The tensors among an op's arguments or outputs: a tensor, or
    tuples, lists and dicts of them (one op's are at most two deep)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    out = []
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple, dict)):
            out.extend(flat_tensors(x))
    return out


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _matmul_flops(name: str, args, out) -> int:
    """2 per multiply-accumulate, plus the add of an `add*` op's input."""
    add = name.startswith(("add", "badd", "_addmm"))
    a, b = args[1:3] if add else args[:2]
    k = a.shape[-1]
    if name == "addbmm":
        macs = a.shape[0] * a.shape[1] * b.shape[2] * k
    else:
        macs = _numel(out) * k
    return 2 * macs + (_numel(out) if add else 0)


def _conv_flops(args, out) -> int:
    """aten.convolution(input, weight, ...): each output element takes
    C_in/groups x prod(kernel) multiply-accumulates."""
    w = args[1]
    return 2 * _numel(out) * w.shape[1] * math.prod(w.shape[2:])


def _conv_backward_flops(args) -> int:
    """aten.convolution_backward(grad, input, weight, ..., output_mask):
    the input gradient and the weight gradient each cost one forward."""
    grad, _, w = args[:3]
    mask = args[-1]
    fwd = 2 * _numel(grad) * w.shape[1] * math.prod(w.shape[2:])
    return fwd * (int(bool(mask[0])) + int(bool(mask[1])))


def _pow_cost(args, n_out) -> tuple[int, int]:
    """x ** e: a multiply for e = 2 (JAX's integer_pow), a divide for
    e = -1, else a transcendental power."""
    e = args[1] if len(args) > 1 else None
    if isinstance(e, (int, float)) and e in (2, -1, 1):
        return (n_out if e != 1 else 0), 0
    return 0, n_out


_KINDS = (("matmul", _MATMUL), ("transcendental", _TRANSCENDENTAL),
          ("pointwise", _POINTWISE), ("reduction", _REDUCTION),
          ("fused", _FUSED), ("none", _NO_KERNEL))


@functools.cache
def _kind(func) -> tuple[str, str]:
    """(name, kind) of an aten op overload."""
    name = func.overloadpacket.__name__.rstrip("_")
    if name in ("convolution", "convolution_backward", "pow"):
        return name, name
    for kind, names in _KINDS:
        if name in names:
            return name, kind
    return name, "other"


def op_cost(func, args, kwargs, out) -> tuple[str, int, int, int]:
    """(name, flops, transcendentals, bytes) of one dispatched aten op."""
    name, kind = _kind(func)
    if kind == "none":
        return name, 0, 0, 0
    outs = flat_tensors(out)
    nbytes = sum(t.numel() * t.element_size()
                 for t in flat_tensors(args) + flat_tensors(kwargs) + outs)
    n_out = sum(t.numel() for t in outs)
    flops = trans = 0
    if kind == "matmul":
        flops = _matmul_flops(name, args, outs[0])
    elif kind == "convolution":
        flops = _conv_flops(args, outs[0])
    elif kind == "convolution_backward":
        flops = _conv_backward_flops(args)
    elif kind == "pow":
        flops, trans = _pow_cost(args, n_out)
    elif kind == "transcendental":
        trans = n_out
    elif kind == "pointwise":
        flops = n_out
    elif kind == "reduction":
        # 1 per reduced input element; a reduction that also returns the
        # index (argmax, max over a dim) reduces two operands, as XLA's
        # variadic reduce does
        n_in = _numel(args[0]) if args else 0
        two = name in ("argmax", "argmin") or (
            name in ("max", "min") and len(outs) == 2)
        flops = n_in * (2 if two else 1)
        if name in ("mean", "var", "std", "logsumexp"):
            flops += n_out  # the divide (logsumexp: the add of the max)
    elif kind == "fused":
        per_flop, per_trans = _FUSED[name]
        elems = _numel(outs[0]) if outs else 0
        flops, trans = per_flop * elems, per_trans * elems
    return name, flops, trans, nbytes


class MetaMemo:
    """Runs aten ops, reusing on "meta" tensors the output metadata of an
    earlier call with the same signature.

    Many of torch's meta kernels are Python reference implementations
    (~0.3 ms a call), and a model at full depth repeats the same few
    hundred signatures in every layer. A functional op (no mutation, no
    aliased output) on meta tensors makes fresh outputs whose shape,
    stride, dtype and storage size depend only on its inputs' metadata
    and its other arguments, so the outputs of a repeat are made directly
    with that metadata. Everything else runs as it is, and so does an op
    whose first call returned an alias of an input that its schema does
    not declare (`_unsafe_view`).

    `run(func, args, kwargs)` returns (out, key, fresh): `key` names the
    signature when the op is memoized (None otherwise: callers may cache
    anything else that depends only on it), and `fresh` is True when the
    outputs were made here (each on a new storage)."""

    _SCALARS = (int, float, bool, str, type(None), torch.dtype,
                torch.device, torch.layout, torch.memory_format)

    def __init__(self):
        self._out: dict = {}
        self._functional: dict = {}

    def _key(self, x):
        if isinstance(x, torch.Tensor):
            if x.device.type != "meta":
                raise TypeError
            return (x.shape, x.stride(), x.dtype, x.storage_offset())
        if isinstance(x, (list, tuple)):
            return tuple([self._key(v) for v in x])
        if isinstance(x, self._SCALARS):
            return (type(x), x)
        raise TypeError

    def _is_functional(self, func) -> bool:
        got = self._functional.get(func)
        if got is None:
            schema = func._schema
            got = self._functional[func] = not schema.is_mutable and all(
                r.alias_info is None for r in schema.returns)
        return got

    @staticmethod
    def _describe(t):
        if t is None:
            return None
        nbytes = t.untyped_storage().nbytes()
        dense = t.storage_offset() == 0 and nbytes == torch.empty_strided(
            t.shape, t.stride(), dtype=t.dtype,
            device="meta").untyped_storage().nbytes()
        return (t.shape, t.stride(), t.dtype, t.storage_offset(), nbytes,
                dense)

    @staticmethod
    def _make(desc):
        if desc is None:
            return None
        shape, stride, dtype, offset, nbytes, dense = desc
        if dense:
            return torch.empty_strided(shape, stride, dtype=dtype,
                                       device="meta")
        st = torch.empty(nbytes, dtype=torch.uint8, device="meta")
        return torch.empty(0, dtype=dtype, device="meta").set_(
            st.untyped_storage(), offset, shape, stride)

    def run(self, func, args, kwargs):
        if not self._is_functional(func):
            return func(*args, **kwargs), None, False
        try:
            key = (func, self._key(args),
                   self._key(tuple(kwargs.items())) if kwargs else ())
        except TypeError:
            return func(*args, **kwargs), None, False
        desc = self._out.get(key)
        if desc is not None:
            kind, items = desc
            if kind is torch.Tensor:
                return self._make(items), key, True
            return kind(self._make(d) for d in items), key, True
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            outs = [out]
        elif isinstance(out, (tuple, list)):
            outs = out
        else:
            return out, None, False
        if not all(o is None or (isinstance(o, torch.Tensor)
                                 and o.device.type == "meta") for o in outs):
            return out, None, False
        inputs = {id(t.untyped_storage()) for t in flat_tensors(args)}
        if any(o is not None and id(o.untyped_storage()) in inputs
               for o in outs):
            # an alias the schema does not declare (_unsafe_view)
            self._functional[func] = False
            return out, None, False
        if outs is out:
            self._out[key] = (type(out), [self._describe(o) for o in outs])
        else:
            self._out[key] = (torch.Tensor, self._describe(out))
        return out, key, False


class OpCounter(TorchDispatchMode):
    """Counts every aten op dispatched while it is active; on "meta"
    tensors the ops run through a MetaMemo."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.by_op: dict[str, list] = {}
        self._memo = MetaMemo()
        self._costs: dict = {}

    def count(self, func, args, kwargs, out, key=None) -> None:
        """Adds one op's cost; `key`, a MetaMemo signature, caches it."""
        cost = self._costs.get(key) if key is not None else None
        if cost is None:
            cost = op_cost(func, args, kwargs, out) \
                if _kind(func)[1] != "none" else None
            if key is not None:
                self._costs[key] = cost or ()
        if not cost:
            return
        name, flops, trans, nbytes = cost
        self.flops += flops
        self.transcendentals += trans
        self.bytes += nbytes
        row = self.by_op.get(name)
        if row is None:
            row = self.by_op[name] = [0, 0, 0, 0]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        row[3] += trans

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out, key, _ = self._memo.run(func, args, kwargs)
        self.count(func, args, kwargs, out, key)
        return out

    def result(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "transcendentals": self.transcendentals,
                "by_op": {name: dict(zip(("count", "flops", "bytes",
                                          "transcendentals"), row))
                          for name, row in sorted(self.by_op.items())}}


def analyze(fn, *args, **kwargs) -> dict:
    """Runs fn(*args, **kwargs) once and returns its counted work:
    {"flops", "bytes", "transcendentals", "by_op"}."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.result()
