"""Parameter bridge: a ``repro`` parameter tree (as numpy arrays) → the same
nested dict of torch tensors, a ``repro`` ``QuantizerState``'s codebooks
→ the port's ``QuantizerState``, and a ``repro`` ``LutTables`` (its
fields, numpy already) → the port's.

The caller converts the JAX objects first, e.g.
``jax.tree_util.tree_map(np.asarray, params)`` and
``{p: np.asarray(c) for p, c in state.codebooks.items()}``; this module
never sees JAX.  The index form passes through unchanged: int8/int16
``w_idx`` keep their negative ids, and ``codebook``/``lut_table`` keep their
values and dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lut import LutTables
from repro_torch.core.quantizer import QuantizerState
from repro_torch.device import resolve_device

__all__ = ["from_jax_params", "from_jax_state", "from_jax_lut_tables",
           "to_numpy_tree"]


def _tensor(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16, bit for bit
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def from_jax_params(tree, device=None):
    """Nested dict of numpy arrays → torch tensors on ``device`` (the GPU
    when None)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _tensor(node, dev)

    return walk(tree)


def from_jax_state(codebooks: dict, last_step: int = -1,
                   device=None) -> QuantizerState:
    """A reference ``QuantizerState`` as {path: numpy codebook} (``''`` for
    the global scope, ``'blocks/mlp/w1/w'``-style paths for per_layer) →
    the port's, codebooks as f32 tensors on ``device`` (the GPU when
    None), bit for bit."""
    dev = resolve_device(device)
    return QuantizerState(codebooks={p: _tensor(c, dev)
                                     for p, c in codebooks.items()},
                          last_step=last_step)


def from_jax_lut_tables(fields: dict) -> LutTables:
    """``dataclasses.asdict`` of a reference ``LutTables`` (numpy arrays,
    ints, a float and a numpy dtype) → the port's ``LutTables``, arrays
    copied with their dtypes."""
    arrays = {k: np.array(fields[k]) for k in ("mult", "act_table",
                                                "levels", "codebook")}
    return LutTables(**arrays, s=int(fields["s"]), dx=float(fields["dx"]),
                     zero_offset=int(fields["zero_offset"]),
                     bias_row=int(fields["bias_row"]),
                     identity_col=int(fields["identity_col"]),
                     acc_dtype=np.dtype(fields["acc_dtype"]))


def to_numpy_tree(tree):
    """Nested dict of tensors → numpy arrays (bf16 as float32)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()
