"""IEF transformer-decoder head and MLP head (port of
``smilify_tpu/models/transformer_decoder.py``).

A single query token embeds the current parameter estimate; ``depth``
decoder layers cross-attend the backbone's tokens; per-group linear heads
emit deltas that are added to the running estimate (Iterative Error
Feedback, ``ief_iters`` iterations). The initial estimate is a learned
parameter that starts at the 6D identity for rotations. Each iteration's
estimate is returned in the history list.

Submodules carry the Flax module names (``layer_0``, ``head_betas``,
``MultiHeadDotProductAttention_0``...), so ``weight_port.state_dict_from_flax``
maps the JAX package's parameters one to one. Flax's defaults are kept:
LayerNorm eps 1e-6 and the tanh-approximated GELU.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from smilify_tpu_torch.models.backbones import FLAX_LN_EPS


def identity_init_for_group(name: str, dim: int, n_pose: int = 0) -> np.ndarray:
    """Initial estimate per group: 6D identity for rotation groups, the
    identity camera, fov 60, the default camera distance, zeros else."""
    ident6 = np.array([1, 0, 0, 0, 1, 0], dtype=np.float32)
    if name == "global_rot" and dim == 6:
        return ident6
    if name == "joint_rot" and n_pose and dim == 6 * n_pose:
        return np.tile(ident6, n_pose)
    if name == "cam_rot" and dim == 9:
        return np.eye(3, dtype=np.float32).reshape(-1)
    if name == "fov" and dim == 1:
        return np.asarray([60.0], dtype=np.float32)
    if name == "cam_trans" and dim == 3:
        # the default camera distance: a camera inside the mesh makes the
        # projection losses blow up
        return np.asarray([0.0, 0.0, 2.7], dtype=np.float32)
    return np.zeros(dim, dtype=np.float32)


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=FLAX_LN_EPS)


class MultiHeadDotProductAttention(nn.Module):
    """Flax's ``nn.MultiHeadDotProductAttention``: query/key/value/out
    projections (qkv_features = out_features = ``dim``) and softmax
    attention scaled by 1/√head_dim.

    ``mask`` (broadcastable to (B, heads, Lq, Lk), True = attend) is applied
    as Flax applies it: masked logits become the dtype's most negative
    value, so a row with no key left attends uniformly to all keys (where
    ``scaled_dot_product_attention`` would return NaN)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x_q, x_kv, mask: Optional[torch.Tensor] = None):
        B, Lq, D = x_q.shape
        H = self.num_heads
        q = self.query(x_q).view(B, Lq, H, D // H).transpose(1, 2)
        k = self.key(x_kv).view(B, -1, H, D // H).transpose(1, 2)
        v = self.value(x_kv).view(B, -1, H, D // H).transpose(1, 2)
        if mask is None:
            y = F.scaled_dot_product_attention(q, k, v)
        else:
            logits = torch.matmul(q, k.transpose(-1, -2)) / (D // H) ** 0.5
            logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
            y = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.out(y.transpose(1, 2).reshape(B, Lq, D))


class DecoderLayer(nn.Module):
    """Self-attention over the query, cross-attention to the memory, MLP;
    pre-norm residuals."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 mlp_dim: Optional[int] = None):
        super().__init__()
        hidden = mlp_dim or int(dim * mlp_ratio)
        self.LayerNorm_0 = _layer_norm(dim)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(dim, num_heads)
        self.LayerNorm_1 = _layer_norm(dim)
        self.MultiHeadDotProductAttention_1 = MultiHeadDotProductAttention(dim, num_heads)
        self.LayerNorm_2 = _layer_norm(dim)
        self.Dense_0 = nn.Linear(dim, hidden)
        self.Dense_1 = nn.Linear(hidden, dim)

    def forward(self, query, memory):
        y = self.LayerNorm_0(query)
        query = query + self.MultiHeadDotProductAttention_0(y, y)
        y = self.LayerNorm_1(query)
        query = query + self.MultiHeadDotProductAttention_1(y, memory)
        y = self.LayerNorm_2(query)
        y = self.Dense_1(F.gelu(self.Dense_0(y), approximate="tanh"))
        return query + y


def _split(estimate: torch.Tensor, group_dims) -> Dict[str, torch.Tensor]:
    out, off = {}, 0
    for name, d in group_dims:
        out[name] = estimate[:, off:off + d]
        off += d
    return out


class SMILTransformerDecoderHead(nn.Module):
    """IEF decoder head over named output groups: tokens (B, T, token_dim)
    → (params dict name → (B, dim), history list)."""

    def __init__(self, group_dims: Sequence[Tuple[str, int]], token_dim: int, dim: int = 512,
                 depth: int = 4, num_heads: int = 8, mlp_dim: Optional[int] = None,
                 ief_iters: int = 3, n_pose: int = 0):
        super().__init__()
        self.group_dims = tuple(group_dims)
        self.ief_iters = ief_iters
        init = np.concatenate([identity_init_for_group(n, d, n_pose) for n, d in self.group_dims])
        self.init_estimate = nn.Parameter(torch.as_tensor(init))
        total = init.shape[0]
        self.memory_proj = nn.Linear(token_dim, dim)
        self.estimate_embed = nn.Linear(total, dim)
        self.estimate_norm = _layer_norm(total)
        self.depth = depth
        for i in range(depth):
            setattr(self, f"layer_{i}", DecoderLayer(dim, num_heads, mlp_dim=mlp_dim))
        for name, d in self.group_dims:
            head = nn.Linear(dim, d)
            nn.init.zeros_(head.weight)
            nn.init.zeros_(head.bias)
            setattr(self, f"head_{name}", head)

    def forward(self, tokens: torch.Tensor):
        B = tokens.shape[0]
        memory = self.memory_proj(tokens)
        estimate = self.init_estimate.expand(B, -1)
        history = []
        for _ in range(self.ief_iters):
            q = self.estimate_embed(self.estimate_norm(estimate))[:, None, :]
            for i in range(self.depth):
                q = getattr(self, f"layer_{i}")(q, memory)
            q = q[:, 0]
            deltas = [getattr(self, f"head_{name}")(q) for name, _ in self.group_dims]
            estimate = estimate + torch.cat(deltas, dim=-1)
            history.append(estimate)
        return _split(estimate, self.group_dims), history


class MLPHead(nn.Module):
    """3×(Linear + LayerNorm + ReLU + dropout) then one linear head a group,
    its bias at the group's initial estimate."""

    def __init__(self, group_dims: Sequence[Tuple[str, int]], in_dim: int, hidden: int = 1024,
                 dropout: float = 0.1, n_pose: int = 0):
        super().__init__()
        self.group_dims = tuple(group_dims)
        self.dropout = dropout
        for i in range(3):
            setattr(self, f"Dense_{i}", nn.Linear(in_dim if i == 0 else hidden, hidden))
            setattr(self, f"LayerNorm_{i}", _layer_norm(hidden))
        for name, d in self.group_dims:
            head = nn.Linear(hidden, d)
            nn.init.zeros_(head.weight)
            with torch.no_grad():
                head.bias.copy_(torch.as_tensor(identity_init_for_group(name, d, n_pose)))
            setattr(self, f"head_{name}", head)

    def forward(self, pooled: torch.Tensor):
        x = pooled
        for i in range(3):
            x = F.relu(getattr(self, f"LayerNorm_{i}")(getattr(self, f"Dense_{i}")(x)))
            x = F.dropout(x, self.dropout, self.training)
        return {name: getattr(self, f"head_{name}")(x) for name, _ in self.group_dims}, []
