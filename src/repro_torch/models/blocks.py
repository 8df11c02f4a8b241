"""Transformer blocks.  Counterpart of `repro.models.blocks`, with one
`nn.Module` per layer (the model holds them in an `nn.ModuleList`)
instead of the reference's stacked `(L, ...)` leaves under `lax.scan`.

The port carries the dense block: pre-norm, attention, residual,
pre-norm, MLP, residual.  The state-space, hybrid and mixture blocks
raise `NotImplementedError` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.attention import Attention, KVCache
from repro_torch.models.mlp import MLP
from repro_torch.models.norms import Norm

NOT_PORTED = {
    "ssm": "ROADMAP queue A8b (SSM and hybrid blocks with ssd_intra)",
    "hybrid": "ROADMAP queue A8b (SSM and hybrid blocks with ssd_intra)",
    "moe": "ROADMAP queue A8c (MoE blocks)",
    "vlm": "ROADMAP queue A8d (modality prefixes)",
    "audio": "ROADMAP queue A8d (modality prefixes)",
}


def check_supported(cfg: ModelConfig) -> None:
    kind = "moe" if cfg.moe is not None else cfg.arch_type
    if kind in NOT_PORTED:
        raise NotImplementedError(f"{cfg.name}: {kind} blocks are not "
                                  f"ported yet: {NOT_PORTED[kind]}")
    if kind != "dense" or not cfg.rope or cfg.prefix_len:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense RoPE decoders without a "
            f"modality prefix: {NOT_PORTED['vlm']}")


def layer_window(cfg: ModelConfig, layer: int) -> int:
    """The layer's attention window (0 = full): hybrid global layers
    attend fully, every other layer uses the config's window."""
    return 0 if layer in cfg.global_layers else cfg.sliding_window


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        check_supported(cfg)
        self.norm1 = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.norm2 = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation, dtype, device,
                       cfg.mlp_bias)

    def prefill(self, x, positions, window: int, impl: str = "kernel"):
        """Full block over a sequence.  Returns (x, (k, v))."""
        mix, kv = self.attn.prefill(self.norm1(x), positions, window, impl)
        x = x + mix
        return x + self.mlp(self.norm2(x)), kv

    def decode(self, x, pos: int, cache: KVCache, window: int, valid=None,
               impl: str = "kernel"):
        """One token.  Returns (x, cache), the cache updated in place."""
        mix, cache = self.attn.decode(self.norm1(x), pos, cache, window,
                                      valid, impl)
        x = x + mix
        return x + self.mlp(self.norm2(x)), cache
