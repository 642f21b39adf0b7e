"""CLIP ViT-L/14 text encoder (SD-1.5's text conditioning).

Counterpart: `diffcodec_tpu/models/clip_text.py` (`CLIPTextEncoder`
:21-83), the frozen HF `CLIPTextModel` the reference loads: token and
position embeddings, pre-LN transformer layers with a quick-GELU MLP, a
causal mask and the final LayerNorm.  The output, `last_hidden_state`
[B, L, D], is the cross-attention context of the UNet and the ControlNet.

Attribute names are HF's (`text_model.embeddings.token_embedding`, ...,
`clip_text_name_map` in `diffcodec_tpu_torch/weights.py`).  The attention
keeps JAX's arithmetic, which XLA computed outside any Pallas kernel
(`clip_text.py:38-43`): fp32 logits times the scale, masked to -1e9 above
the diagonal, an fp32 softmax, the probabilities cast to V's dtype before
their product with V.  It stays plain PyTorch: the port's attention kernel
takes no mask.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from diffcodec_tpu_torch.config import CLIPTextConfig


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        hd = D // self.heads
        q, k, v = (p(x).reshape(B, L, self.heads, hd)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) * hd ** -0.5
        logits = torch.where(causal, logits, torch.full_like(logits, -1e9))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, D)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPLayer(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.self_attn = CLIPAttention(dim, heads)
        self.layer_norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = CLIPMLP(dim)

    def forward(self, x, causal):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_dim)
        self.position_embedding = nn.Embedding(cfg.max_length,
                                               cfg.hidden_dim)

    def forward(self, input_ids):
        L = input_ids.shape[1]
        return (self.token_embedding(input_ids)
                + self.position_embedding.weight[None, :L])


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPLayer(cfg.hidden_dim, cfg.heads)
                                     for _ in range(cfg.layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_dim, eps=1e-5)


class CLIPTextEncoder(nn.Module):
    """input_ids [B, L] (integers) -> last_hidden_state [B, L, D] in the
    weights' dtype."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        dev = tm.final_layer_norm.weight.device
        input_ids = torch.as_tensor(input_ids, device=dev).long()
        L = input_ids.shape[1]
        x = tm.embeddings(input_ids)
        causal = torch.ones(L, L, dtype=torch.bool, device=dev).tril()
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        return tm.final_layer_norm(x)
