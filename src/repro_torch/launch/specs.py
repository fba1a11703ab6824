"""Abstract input specs per (architecture x run shape) (the port of
`repro.launch.specs`).

For every model input a `Spec`, its shape and dtype name (the counterpart
of a `jax.ShapeDtypeStruct`), and the input's logical axes, from which the
shardings come. `make_batch` draws a batch of those specs from a
numpy generator exactly as the reference does, so one seed gives the same
integers and the same normals before the cast.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.config import ArchConfig, RunShape
from repro_torch.distributed.sharding import HeadLayout, Rules, sharding_for
from repro_torch.models import model as M
from repro_torch.pspec import torch_dtype


@dataclass(frozen=True)
class Spec:
    """An input's shape and dtype name ("int32", "float32", "bfloat16")."""
    shape: Tuple[int, ...]
    dtype: str

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def is_integer(self) -> bool:
        return not self.torch_dtype.is_floating_point


Specs = Dict[str, Spec]
Axes = Dict[str, Tuple]


def _sds(shape, dtype) -> Spec:
    return Spec(tuple(int(d) for d in shape), dtype)


def input_specs(cfg: ArchConfig, shape: RunShape) -> Tuple[Specs, Axes]:
    """Returns ({name: Spec}, {name: logical axes})."""
    B, S = shape.global_batch, shape.seq_len
    E = cfg.d_model
    cd = cfg.compute_dtype

    if shape.kind in ("train", "prefill"):
        specs: Specs = {}
        axes: Axes = {}
        if cfg.family == "encdec":
            Td = cfg.encdec.dec_len
            specs["enc_embeds"] = _sds((B, S, E), cd)
            axes["enc_embeds"] = ("batch", None, None)
            specs["dec_inputs"] = _sds((B, Td), "int32")
            axes["dec_inputs"] = ("batch", None)
            if shape.kind == "train":
                specs["targets"] = _sds((B, Td), "int32")
                axes["targets"] = ("batch", None)
            return specs, axes
        if cfg.embeds_input:
            specs["embeds"] = _sds((B, S, E), cd)
            axes["embeds"] = ("batch", None, None)
            if cfg.pos == "mrope":
                specs["positions"] = _sds((B, S, 3), "int32")
                axes["positions"] = ("batch", None, None)
        else:
            specs["inputs"] = _sds((B, S), "int32")
            axes["inputs"] = ("batch", None)
        if shape.kind == "train":
            specs["targets"] = _sds((B, S), "int32")
            axes["targets"] = ("batch", None)
        return specs, axes

    # decode: one new token against a seq_len cache
    specs = {"token": _sds((B,), "int32"), "pos": _sds((B,), "int32")}
    axes = {"token": ("batch",), "pos": ("batch",)}
    if cfg.embeds_input and cfg.family != "encdec":
        specs["embeds"] = _sds((B, 1, E), cd)
        axes["embeds"] = ("batch", None, None)
    return specs, axes


def batch_shardings(cfg: ArchConfig, shape: RunShape, rules: Rules, mesh):
    specs, axes = input_specs(cfg, shape)
    return {k: sharding_for(specs[k].shape, axes[k], rules, mesh)
            for k in specs}


def decode_cache_abstract(cfg: ArchConfig, layout: HeadLayout,
                          shape: RunShape):
    """The cache's ParamSpec tree for a decode shape (cache length =
    seq_len)."""
    return M.cache_specs(cfg, layout, shape.global_batch, shape.seq_len)


def make_batch(cfg: ArchConfig, shape: RunShape, rng=None, batch=None,
               seq=None, *, device="cuda"):
    """A random batch matching `input_specs`, drawn from `rng` (a numpy
    generator; `default_rng(0)` when None) as the reference draws it:
    integers in [0, vocab) for token inputs and [0, max(seq, 4)) for the
    others, standard normals in f32 cast to the spec's dtype. Tensors on
    `device`."""
    rng = rng or np.random.default_rng(0)
    sh = shape
    if batch or seq:
        sh = dataclasses.replace(shape,
                                 global_batch=batch or shape.global_batch,
                                 seq_len=seq or shape.seq_len)
    specs, _ = input_specs(cfg, sh)
    out = {}
    for k, s in specs.items():
        if s.is_integer:
            hi = (cfg.vocab_size if k in ("inputs", "targets", "dec_inputs",
                                          "token") else max(sh.seq_len, 4))
            a = rng.integers(0, hi, s.shape)
            out[k] = torch.as_tensor(a.astype(np.int32)).to(device)
        else:
            a = rng.normal(size=s.shape).astype(np.float32)
            out[k] = torch.as_tensor(a).to(device).to(s.torch_dtype)
    return out
