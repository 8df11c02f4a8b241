"""The port's data pipeline, checkpoints and training launcher, on the
CPU.

* `make_batches` equals the reference's bit for bit: seeds 0 and 7,
  ranks 0 and 1, three batches each; the reference's own shape, shift,
  rank and seed tests on the port.
* A train state (a bf16 model after one step, its float32 master and
  moments, the int32 step) round-trips bit for bit through
  `save_checkpoint` / `restore_checkpoint`, keeping every tensor's dtype
  and device; `latest_step` finds it, no `.tmp` file is left, the
  metadata is the reference's, and a missing key raises `ValueError`.
  The file holds the keys the reference's flattening gives a
  `TrainState`, with the port's per-layer parameter paths.
* `launch.train.run(..., device="cpu")` trains a smoke config and
  writes its checkpoint, and `main` takes `--device`.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.data import DataConfig as RefDataConfig
from repro.data import make_batches as ref_make_batches
from repro_torch.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.config import TrainConfig
from repro_torch.configs import get_smoke
from repro_torch.data import DataConfig, make_batches
from repro_torch.launch import train as train_launcher
from repro_torch.models import init_model
from repro_torch.training.train_step import init_train_state, train_step

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("rank", [0, 1])
def test_batches_equal_the_references(seed, rank):
    kw = dict(vocab=512, seq_len=64, batch=4, seed=seed, rank=rank, world=2)
    ours, theirs = make_batches(DataConfig(**kw)), ref_make_batches(
        RefDataConfig(**kw))
    for _, a, b in zip(range(3), ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_batch_shapes_shift_rank_and_seed():
    b = next(make_batches(DataConfig(vocab=512, seq_len=64, batch=4)))
    assert b["tokens"].shape == (4, 64) and b["labels"].shape == (4, 64)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 512
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    r0 = next(make_batches(DataConfig(vocab=128, seq_len=16, batch=2)))
    r1 = next(make_batches(DataConfig(vocab=128, seq_len=16, batch=2,
                                      rank=1)))
    assert not np.array_equal(r0["tokens"], r1["tokens"])
    s0 = next(make_batches(DataConfig(vocab=128, seq_len=16, batch=2,
                                      seed=7)))
    s1 = next(make_batches(DataConfig(vocab=128, seq_len=16, batch=2,
                                      seed=7)))
    np.testing.assert_array_equal(s0["tokens"], s1["tokens"])


def _trained_state():
    """qwen-smoke (bf16, QKV biases) after one train step: nonzero
    moments, step 1."""
    cfg = get_smoke("qwen1.5-32b")
    tc = TrainConfig()
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = init_train_state(model, tc, device="cpu")
    b = next(make_batches(DataConfig(vocab=cfg.vocab, seq_len=16, batch=2)))
    state, _ = train_step(state, {k: torch.from_numpy(v)
                                  for k, v in b.items()}, tc)
    return cfg, tc, state


def _tensors(state):
    return ([p.detach() for p in state.model.parameters()]
            + [state.opt.step] + [t for d in state.opt[1:]
                                  for t in d.values()])


def test_train_state_round_trips_bit_for_bit(tmp_path):
    cfg, tc, state = _trained_state()
    save_checkpoint(str(tmp_path), 3, state, {"arch": cfg.name})
    assert latest_step(str(tmp_path)) == 3
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    meta = json.loads((tmp_path / "ckpt_00000003.json").read_text())
    want_keys = ({f"model/{n.replace('.', '/')}"
                  for n, _ in state.model.named_parameters()}
                 | {"opt/step"}
                 | {f"opt/{f}/{n.replace('.', '/')}"
                    for f in ("master", "m", "v")
                    for n, _ in state.model.named_parameters()})
    with np.load(tmp_path / "ckpt_00000003.npz") as data:
        assert set(data.files) == want_keys
        assert data["model/embed"].dtype == np.uint16   # bf16 bits
    assert meta == {"step": 3, "n_arrays": len(want_keys),
                    "arch": cfg.name}

    # restore into a zeroed state of the same structure
    model2 = init_model(cfg, torch.Generator().manual_seed(5), device="cpu")
    fresh = init_train_state(model2, tc, device="cpu")
    with torch.no_grad():
        for t in _tensors(fresh):
            t.zero_()
    restored = restore_checkpoint(str(tmp_path), 3, fresh)
    assert restored is fresh
    for a, b in zip(_tensors(restored), _tensors(state)):
        assert a.dtype == b.dtype and a.device == b.device
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b)
    assert any(p.dtype == torch.bfloat16 for p in restored.model.parameters())
    assert int(restored.opt.step) == 1


def test_missing_key_raises(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="missing"):
        restore_checkpoint(str(tmp_path), 0, {"a": torch.zeros(3),
                                              "b": torch.zeros(2)})
    assert latest_step(str(tmp_path / "nowhere")) is None


def test_launcher_trains_on_the_cpu_and_writes_a_checkpoint(tmp_path,
                                                            capsys):
    losses = train_launcher.run("internvl2-1b", smoke=True, steps=4, batch=2,
                                seq=16, lr=3e-3, microbatches=2,
                                ckpt_dir=str(tmp_path), log_every=2,
                                device="cpu")
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert latest_step(str(tmp_path)) == 4
    meta = json.loads((tmp_path / "ckpt_00000004.json").read_text())
    assert meta["arch"] == "internvl2-smoke" and meta["loss"] == losses[-1]
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step     3 loss" in out
    train_launcher.main(["--arch", "stablelm-1.6b", "--smoke", "--steps",
                         "2", "--batch", "2", "--seq", "8", "--device",
                         "cpu"])
    assert "final loss" in capsys.readouterr().out
