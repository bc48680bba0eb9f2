"""Minimal module layer for the model zoo, in plain JAX.

Covers exactly what the zoo uses, with Flax-linen's interface and
parameter-tree names so models and checkpoints read the same:

- ``Module`` subclasses are frozen dataclasses; ``@compact`` marks the
  ``__call__`` that creates parameters and submodules inline.
- ``Module.init(rngs, *args, **kw)`` returns ``{"params": ...,
  "batch_stats": ...}``; ``Module.apply(variables, *args, rngs=...,
  mutable=[...], **kw)`` returns the output, plus the updated mutable
  collections when ``mutable`` is given.
- Layers: ``Dense`` (``kernel``/``bias``), ``Conv`` (``kernel`` of shape
  ``kernel_size + (in, out)``, ``bias``), ``BatchNorm`` (params
  ``scale``/``bias``, ``batch_stats`` ``mean``/``var``), ``Dropout``.

Unnamed submodules are named ``<ClassName>_<k>`` in call order, as in
Flax.  Parameter and dropout keys are derived from the module path with
``fold_in``, so values are deterministic given the root key but are not
bit-identical to Flax's.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import zlib
from typing import Any, Callable

import jax
import jax.numpy as jnp

#: The initializers Flax re-exports (glorot_uniform, lecun_normal, ...).
initializers = jax.nn.initializers

relu = jax.nn.relu
sigmoid = jax.nn.sigmoid
softmax = jax.nn.softmax

_STACK = threading.local()


def _frames() -> list:
    if not hasattr(_STACK, "frames"):
        _STACK.frames = []
    return _STACK.frames


class _Context:
    """State shared by one ``init``/``apply`` call."""

    def __init__(self, variables: dict, rngs: dict, mutable: set,
                 initializing: bool):
        self.variables = variables
        self.rngs = rngs
        self.mutable = mutable
        self.initializing = initializing
        self.rng_counts: dict = {}


class _Frame:
    """One module's place in the tree during a call."""

    def __init__(self, ctx: _Context, path: tuple):
        self.ctx = ctx
        self.path = path
        self.child_counts: dict = {}

    def collection(self, col: str, create: bool) -> dict | None:
        node = self.ctx.variables.get(col)
        if node is None:
            if not create:
                return None
            node = self.ctx.variables[col] = {}
        for p in self.path:
            nxt = node.get(p)
            if nxt is None:
                if not create:
                    return None
                nxt = node[p] = {}
            node = nxt
        return node


def _path_key(key, path: tuple, salt: str):
    return jax.random.fold_in(
        key, zlib.crc32(("/".join(path) + "#" + salt).encode()))


class Variable:
    """A mutable slot in a non-param collection (``batch_stats``)."""

    def __init__(self, frame: _Frame, col: str, name: str):
        self._frame, self._col, self._name = frame, col, name

    @property
    def value(self):
        return self._frame.collection(self._col, False)[self._name]

    @value.setter
    def value(self, v):
        ctx = self._frame.ctx
        if not (ctx.initializing or self._col in ctx.mutable):
            raise ValueError(f"collection {self._col!r} is not mutable")
        self._frame.collection(self._col, True)[self._name] = v


def compact(fn: Callable) -> Callable:
    """Mark a module's ``__call__`` as the place it builds its tree."""

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        frames = _frames()
        if not frames:
            raise RuntimeError(f"{type(self).__name__} called outside "
                               "init/apply")
        parent = frames[-1]
        if getattr(self, "_root", False):
            frame = parent
            object.__setattr__(self, "_root", False)
        else:
            name = self.name
            if name is None:
                cls = type(self).__name__
                k = parent.child_counts.get(cls, 0)
                parent.child_counts[cls] = k + 1
                name = f"{cls}_{k}"
            frame = _Frame(parent.ctx, parent.path + (name,))
        frames.append(frame)
        try:
            return fn(self, *args, **kwargs)
        finally:
            frames.pop()

    return wrapped


@dataclasses.dataclass(frozen=True)
class Module:
    """Base class: subclasses become frozen dataclasses of their fields."""

    name: str | None = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)

    # -- inside a compact call -------------------------------------------
    @staticmethod
    def _frame() -> _Frame:
        return _frames()[-1]

    def param(self, name: str, init_fn: Callable, *init_args) -> Any:
        frame = self._frame()
        store = frame.collection("params", frame.ctx.initializing)
        if store is not None and name in store:
            return store[name]
        if not frame.ctx.initializing:
            raise KeyError(f"missing parameter {'/'.join(frame.path)}/{name}")
        value = init_fn(_path_key(frame.ctx.rngs["params"], frame.path,
                                  name), *init_args)
        store[name] = value
        return value

    def variable(self, col: str, name: str, init_fn: Callable,
                 *init_args) -> Variable:
        frame = self._frame()
        store = frame.collection(col, frame.ctx.initializing)
        if store is not None and name not in store:
            if not frame.ctx.initializing:
                raise KeyError(f"missing {col} {'/'.join(frame.path)}/{name}")
            store[name] = init_fn(*init_args)
        return Variable(frame, col, name)

    def make_rng(self, name: str = "dropout"):
        frame = self._frame()
        ctx = frame.ctx
        if name not in ctx.rngs:
            raise ValueError(f"no {name!r} rng was given")
        k = ctx.rng_counts.get((name, frame.path), 0)
        ctx.rng_counts[(name, frame.path)] = k + 1
        return jax.random.fold_in(
            _path_key(ctx.rngs[name], frame.path, name), k)

    def is_initializing(self) -> bool:
        return self._frame().ctx.initializing

    # -- entry points ------------------------------------------------------
    def _run(self, ctx: _Context, args, kwargs, method):
        frames = _frames()
        frames.append(_Frame(ctx, ()))
        object.__setattr__(self, "_root", True)
        try:
            return (method or type(self).__call__)(self, *args, **kwargs)
        finally:
            object.__setattr__(self, "_root", False)
            frames.pop()

    def init(self, rngs, *args, method=None, **kwargs) -> dict:
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        ctx = _Context({}, dict(rngs), set(), initializing=True)
        self._run(ctx, args, kwargs, method)
        return {k: v for k, v in ctx.variables.items() if v}

    def apply(self, variables: dict, *args, rngs=None, mutable=False,
              method=None, **kwargs):
        if isinstance(rngs, jax.Array):
            rngs = {"params": rngs}
        if mutable is True:
            mutable = set(variables)
        elif isinstance(mutable, str):
            mutable = {mutable}
        else:
            mutable = set(mutable or ())
        # Copy the dict skeleton so updates never touch the caller's tree.
        copied = {k: _copy_tree(v) for k, v in variables.items()}
        for col in mutable:
            copied.setdefault(col, {})
        ctx = _Context(copied, dict(rngs or {}), mutable, initializing=False)
        out = self._run(ctx, args, kwargs, method)
        if not mutable:
            return out
        return out, {col: copied[col] for col in mutable}


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


def flatten_dict(tree: dict, prefix: tuple = ()) -> dict:
    """Nested dict -> ``{path_tuple: leaf}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_dict(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _promote(dtype, *xs):
    dtype = dtype or jnp.result_type(*xs)
    return [jnp.asarray(x, dtype) for x in xs]


def _tuple(v, n: int) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


class Dense(Module):
    features: int
    use_bias: bool = True
    dtype: Any = None
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init,
                            (x.shape[-1], self.features), jnp.float32)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           jnp.float32) if self.use_bias else None)
        if bias is None:
            x, kernel = _promote(self.dtype, x, kernel)
        else:
            x, kernel, bias = _promote(self.dtype, x, kernel, bias)
        y = jax.lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
        return y if bias is None else y + bias


class Conv(Module):
    """N-d convolution over ``(batch, *spatial, features)`` inputs."""
    features: int
    kernel_size: tuple
    strides: Any = 1
    padding: Any = "SAME"
    kernel_dilation: Any = 1
    use_bias: bool = True
    dtype: Any = None
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        ks = tuple(self.kernel_size)
        nd = len(ks)
        kernel = self.param("kernel", self.kernel_init,
                            ks + (x.shape[-1], self.features), jnp.float32)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           jnp.float32) if self.use_bias else None)
        if bias is None:
            x, kernel = _promote(self.dtype, x, kernel)
        else:
            x, kernel, bias = _promote(self.dtype, x, kernel, bias)
        lead = x.shape[:-(nd + 1)]
        xb = x.reshape((-1,) + x.shape[-(nd + 1):])
        spatial = "".join("HWD"[i] for i in range(nd)) if nd <= 3 else None
        dn = jax.lax.conv_dimension_numbers(
            xb.shape, kernel.shape,
            ("N" + spatial + "C", spatial + "IO", "N" + spatial + "C"))
        padding = (self.padding if isinstance(self.padding, str)
                   else [tuple(p) for p in self.padding])
        y = jax.lax.conv_general_dilated(
            xb, kernel, window_strides=_tuple(self.strides, nd),
            padding=padding, rhs_dilation=_tuple(self.kernel_dilation, nd),
            dimension_numbers=dn)
        y = y.reshape(lead + y.shape[1:])
        return y if bias is None else y + bias


class BatchNorm(Module):
    """Batch normalization over the last axis (Flax/Keras semantics)."""
    use_running_average: bool = False
    momentum: float = 0.99
    epsilon: float = 1e-5
    dtype: Any = None

    @compact
    def __call__(self, x):
        axes = tuple(range(x.ndim - 1))
        C = x.shape[-1]
        ra_mean = self.variable("batch_stats", "mean",
                                lambda: jnp.zeros((C,), jnp.float32))
        ra_var = self.variable("batch_stats", "var",
                               lambda: jnp.ones((C,), jnp.float32))
        if self.use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            xf = x.astype(jnp.float32)
            mean = jnp.mean(xf, axes)
            var = jnp.maximum(0.0, jnp.mean(xf * xf, axes) - mean * mean)
            if not self.is_initializing():
                m = self.momentum
                ra_mean.value = m * ra_mean.value + (1 - m) * mean
                ra_var.value = m * ra_var.value + (1 - m) * var
        scale = self.param("scale", initializers.ones, (C,), jnp.float32)
        bias = self.param("bias", initializers.zeros, (C,), jnp.float32)
        y = (x - mean) * (jax.lax.rsqrt(var + self.epsilon) * scale) + bias
        return y.astype(self.dtype or jnp.result_type(x, scale))


class Dropout(Module):
    rate: float
    deterministic: bool = False

    @compact
    def __call__(self, x):
        if self.rate == 0.0 or self.deterministic:
            return x
        if self.rate == 1.0:
            return jnp.zeros_like(x)
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("dropout"), keep, x.shape)
        return jax.lax.select(mask, x / keep, jnp.zeros_like(x))


def param_table(module: Module, rng, *args, **kwargs) -> str:
    """A Keras-summary-like table of every parameter and batch-stat
    array: path, shape, size, and the total count."""
    variables = jax.eval_shape(lambda r: module.init(r, *args, **kwargs),
                               rng)
    lines = [f"{'collection':<12} {'path':<56} {'shape':<20} size"]
    total = 0
    for col, tree in variables.items():
        for path, leaf in flatten_dict(tree).items():
            size = 1
            for d in leaf.shape:
                size *= d
            total += size if col == "params" else 0
            lines.append(f"{col:<12} {'/'.join(path):<56} "
                         f"{str(tuple(leaf.shape)):<20} {size}")
    lines.append(f"Total params: {total}")
    return "\n".join(lines) + "\n"
