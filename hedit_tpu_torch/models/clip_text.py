"""CLIP text encoder, the ViT-L/14 text tower of SD-1.x
(port of ``hedit_tpu/models/clip_text.py``): 12 layers, d=768, 12 heads,
quick_gelu, causal mask, final LayerNorm; returns ``last_hidden_state``.
Parameter names are the transformers ``CLIPTextModel`` state_dict keys.
Its 77-token attention is small and stays plain PyTorch, as the JAX model
leaves it to XLA.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    intermediate_size: int = 3072

    @staticmethod
    def sd15() -> "CLIPTextConfig":
        return CLIPTextConfig()

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
                              intermediate_size=64)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x, mask):
        b, s, d = x.shape
        hd = d // self.heads
        split = lambda t: t.reshape(b, s, self.heads, hd).transpose(1, 2)  # noqa: E731
        q = split(self.q_proj(x) * hd ** -0.5)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        probs = torch.softmax((q @ k.transpose(-1, -2)).float() + mask, dim=-1).to(x.dtype)
        out = (probs @ v).transpose(1, 2).reshape(b, s, d)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))  # quick_gelu


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextTransformer(cfg)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids [B, S] -> last_hidden_state [B, S, hidden]."""
        tm = self.text_model
        s = input_ids.shape[1]
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[:s]
        mask = torch.full((s, s), torch.finfo(torch.float32).min, device=x.device).triu(1)
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)
