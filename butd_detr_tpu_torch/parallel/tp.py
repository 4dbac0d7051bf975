"""Tensor parallelism over the mesh's mp group: the sharding rules by the
port's parameter names, and the shard / unshard of a state dict.

Counterpart of `butd_detr_tpu/parallel/tp.py`, whose `param_pspec` lays
the Megatron column/row layout on the flax tree and lets XLA insert the
collectives. The port keeps the reference's torch names, so the same rules
read (torch weights are (out, in)):

  * q/k/v projections, packed in `*.in_proj_weight` (3d, d) and
    `*.in_proj_bias` (3d,): column-parallel. A rank's shard is three row
    blocks, one each of q, k and v, covering its H/mp heads.
  * `*.out_proj.weight` (d, d): row-parallel, split along its input
    columns; its bias replicated, added after the all-reduce.
  * the FFNs (`*.ffn*.0` and `*.ffn*.3`): `0.weight` and `0.bias` column-,
    `3.weight` row-parallel, `3.bias` replicated.
  * `text_encoder.*`, `backbone_net.*` and everything else: replicated.

A dimension that mp does not divide falls back to replicated, as the JAX
package's `state_shardings` does. Where d divides but the attention's head
count does not, XLA splits a head across devices; the port computes whole
heads on a rank and raises instead (`shard_model_`).

`shard_model_` puts a rank's shards into a built model and switches its
attention and FFN layers onto the mp group; `gather_full_state_dict` turns
a rank's state dict back into the one-process one (every mp rank calls
it). `shard_state_dict` / `unshard_state_dicts` do the same on the host
for a list of ranks' dicts.
"""

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

Spec = Tuple[int, int]  # (dimension split over mp, packed blocks along it)

_REPLICATED = ("text_encoder", "backbone_net")


def _rule(name: str) -> Optional[Spec]:
    """The layout that `name` takes when its dimension divides."""
    parts = name.split(".")
    if parts[0] in _REPLICATED:
        return None
    if parts[-1] in ("in_proj_weight", "in_proj_bias"):
        return (0, 3)
    if parts[-2:] == ["out_proj", "weight"]:
        return (1, 1)
    if len(parts) >= 3 and parts[-3].startswith("ffn"):
        if parts[-2] == "0":
            return (0, 1)
        if parts[-2:] == ["3", "weight"]:
            return (1, 1)
    return None


def param_spec(name: str, shape, mp: int) -> Optional[Spec]:
    """(dim, blocks) along which parameter `name` of `shape` is split over
    `mp` ranks, or None when it is replicated (including the fallback of a
    dimension that does not divide)."""
    spec = _rule(name)
    if spec is None or mp == 1:
        return None
    dim, blocks = spec
    if dim >= len(shape) or (shape[dim] // blocks) % mp:
        return None
    return spec


def shard_tensor(t: torch.Tensor, spec: Spec, mp: int,
                 index: int) -> torch.Tensor:
    """Rank `index`'s shard of the full tensor `t`."""
    dim, blocks = spec
    return torch.cat([block.chunk(mp, dim)[index]
                      for block in t.chunk(blocks, dim)], dim).contiguous()


def unshard_tensors(parts: List[torch.Tensor], spec: Spec) -> torch.Tensor:
    """The full tensor of every rank's shard, in mp order."""
    dim, blocks = spec
    split = [p.chunk(blocks, dim) for p in parts]
    return torch.cat([torch.cat([s[b] for s in split], dim)
                      for b in range(blocks)], dim)


def shard_state_dict(state: Dict[str, torch.Tensor], mp: int,
                     index: int) -> Dict[str, torch.Tensor]:
    """Rank `index`'s state dict of a one-process (full) state dict."""
    out = {}
    for name, t in state.items():
        spec = param_spec(name, tuple(t.shape), mp)
        out[name] = t if spec is None else shard_tensor(t, spec, mp, index)
    return out


def unshard_state_dicts(states: List[Dict[str, torch.Tensor]],
                        specs: Dict[str, Spec]) -> Dict[str, torch.Tensor]:
    """The one-process state dict of every rank's, in mp order; `specs`
    names the sharded entries (`shard_model_`'s return value)."""
    return {name: (unshard_tensors([s[name] for s in states], specs[name])
                   if name in specs else t)
            for name, t in states[0].items()}


def gather_full_state_dict(state: Dict[str, torch.Tensor],
                           specs: Dict[str, Spec],
                           mesh) -> Dict[str, torch.Tensor]:
    """The one-process state dict from this rank's: each sharded entry is
    all-gathered over the mp group (every mp rank must call this, with
    the same entries in the same order)."""
    if mesh.mp_group is None:
        return dict(state)
    from butd_detr_tpu_torch.utils.dist import collective_device

    device = collective_device(mesh.mp_group)
    out = {}
    for name, t in state.items():
        if name not in specs:
            out[name] = t
            continue
        local = t.detach().to(device).contiguous()
        parts = [torch.empty_like(local) for _ in range(mesh.mp)]
        dist.all_gather(parts, local, group=mesh.mp_group)
        out[name] = unshard_tensors(parts, specs[name]).to(t.device)
    return out


def shard_model_(model: torch.nn.Module, mesh) -> Dict[str, Spec]:
    """Replace every sharded parameter of `model` (full, as built or
    loaded) by rank `mesh.mp_index`'s shard and route its attention and
    FFN layers through the mp group. Call before building the optimizer.
    Returns {parameter name: spec} of what was sharded."""
    from butd_detr_tpu_torch.models.encoder import FFN
    from butd_detr_tpu_torch.nn.attention import MultiheadAttention

    mp = mesh.mp
    if mp == 1:
        return {}
    specs = {}
    for name, p in list(model.named_parameters()):
        spec = param_spec(name, tuple(p.shape), mp)
        if spec is None:
            continue
        owner, attr = (model.get_submodule(name.rsplit(".", 1)[0])
                       if "." in name else model), name.rsplit(".", 1)[-1]
        setattr(owner, attr, torch.nn.Parameter(
            shard_tensor(p.data, spec, mp, mesh.mp_index),
            requires_grad=p.requires_grad))
        specs[name] = spec
    for name, m in model.named_modules():
        if isinstance(m, MultiheadAttention) \
                and f"{name}.in_proj_weight" in specs:
            if m.num_heads % mp:
                raise ValueError(
                    f"{name}: {m.num_heads} heads do not split over --mp "
                    f"{mp} (the port keeps whole heads on a rank)")
            m.mp_group = mesh.mp_group
        elif isinstance(m, FFN) and f"{name}.0.weight" in specs:
            m.mp_group = mesh.mp_group
    return specs
