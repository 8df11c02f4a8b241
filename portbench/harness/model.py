"""The system under test: the port's `Model` at a configuration's sizes,
its weights drawn by the benchmark from the seed.

The weights are drawn on the model's device into one flat buffer of the
served dtype with a seeded `torch.Generator` (a few large `normal_`
calls at the configuration's `initializer_range`; every norm scale is
then 1 plus its draw, and biases keep their draws, so that no parameter
the comparison covers is a constant).  `build` hands the same tensors
to the port, by parameter name (`load_state_dict(assign=True)` on a
model built on `meta`, so nothing is copied), and to the reference,
which reads them by the same names.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench.harness.spec import sub_seed

# elements a `normal_` call draws at most
DRAW_CHUNK = 1 << 30
# every parameter starts at a multiple of this many elements (512 bytes
# of bf16), as the caching allocator would align it
ALIGN = 256


def port_config(c: dict):
    """The port's `ModelConfig` for a configuration file: the source's
    keys, and under `port` what the source states by its model type
    (norm, activation, the MoE's capacity rule)."""
    from repro_torch.config import ModelConfig, MoEConfig

    p = c["port"]
    eps = c.get("layer_norm_eps", c.get("rms_norm_eps"))
    if eps != 1e-5:
        raise ValueError(f"{c['name']}: the port's norms use eps 1e-5, the "
                         f"configuration states {eps}")
    moe = None
    if "num_local_experts" in c:
        moe = MoEConfig(n_experts=c["num_local_experts"],
                        top_k=c["num_experts_per_tok"],
                        capacity_factor=p["capacity_factor"],
                        dense_residual=c["use_residual"])
    return ModelConfig(
        name=c["name"], arch_type=p["arch_type"],
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"], n_kv=c["num_key_value_heads"],
        d_ff=c["intermediate_size"], vocab=c["vocab_size"], rope=True,
        rope_fraction=c.get("partial_rotary_factor", 1.0),
        rope_theta=float(c["rope_theta"]),
        qkv_bias=c.get("use_qkv_bias", False), activation=p["activation"],
        norm=p["norm"], tie_embeddings=c["tie_word_embeddings"], moe=moe,
        dtype=c["dtype"])


def draw_weights(shapes: dict, scales: set, c: dict, seed: int,
                 device) -> dict:
    """{name: tensor} for `shapes` ({name: shape}, in order), views of
    one flat buffer of `c["dtype"]` on `device`, drawn normal with
    standard deviation `initializer_range` from the seed; the names in
    `scales` (norm scales) get 1 added."""
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[c["dtype"]]
    offsets, total = {}, 0
    for name, shape in shapes.items():
        offsets[name] = total
        n = 1
        for s in shape:
            n *= s
        total += -(-n // ALIGN) * ALIGN
    flat = torch.empty(total, dtype=dtype, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "weights"))
    std = float(c["initializer_range"])
    for part in flat.split(DRAW_CHUNK):
        part.normal_(0.0, std, generator=g)
    out = {}
    for name, shape in shapes.items():
        n = 1
        for s in shape:
            n *= s
        t = flat[offsets[name]:offsets[name] + n].view(shape)
        if name in scales:
            t.add_(1.0)
        out[name] = t
    return out


@dataclasses.dataclass
class Built:
    cfg: object            # the port's ModelConfig
    model: object          # the port's Model, on the device
    weights: dict          # {parameter name: tensor}, shared with it


def build(c: dict, seed: int, device) -> Built:
    from repro_torch.models.model import Model
    from repro_torch.models.norms import Norm

    cfg = port_config(c)
    meta = Model(cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    scales = {f"{m}.scale" if m else "scale"
              for m, mod in meta.named_modules() if isinstance(mod, Norm)}
    weights = draw_weights(shapes, scales, c, seed, device)
    meta.load_state_dict(weights, strict=True, assign=True)
    return Built(cfg, meta, weights)
