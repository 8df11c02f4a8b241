"""Small sizes of the benchmark's configurations and cells, for the CPU
tests: every mechanism of the full size (partial rotary embedding and
biases; GQA, 8 experts top-2 with the capacity rule in the prefill and
dropless decode steps), at widths a CPU runs in seconds.  The weights'
standard deviation grows as the width shrinks (0.02 x sqrt(d / 256)),
so that activations and logits have the full size's scale and the
cells' limits mean at this size what they mean at the full one."""
from portbench.harness import spec

CONFIG = {
    "stablelm-1.6b": dict(hidden_size=256, intermediate_size=512,
                          num_attention_heads=4, num_key_value_heads=4,
                          num_hidden_layers=2, vocab_size=512,
                          initializer_range=0.02 * (2048 / 256) ** 0.5),
    "arctic-480b-l2": dict(hidden_size=256, intermediate_size=384,
                           num_attention_heads=4, num_key_value_heads=2,
                           num_hidden_layers=2, vocab_size=512,
                           num_local_experts=8,
                           initializer_range=0.02 * (7168 / 256) ** 0.5),
}
PARAMS = {
    "prefill": {"batch": 2, "cycle": 8, "max_seq": 128,
                "length": {"median": 64, "sigma": 0.7, "min": 32,
                           "max": 128, "multiple": 16},
                "check": {"calls": 3, "kv_layers": [0, 1]}},
    "generate": {"batch": 4, "lengths": {"min": 16, "max": 48, "step": 16},
                 "n_new": 8, "max_seq": 64, "check": {"calls": 2}},
}


def config(which: str, **extra) -> dict:
    c = spec.config(which)
    c.update(CONFIG[which], **extra)
    return c


def cell(name: str) -> tuple[dict, dict]:
    """(configuration, parameters) of a cell at the small sizes."""
    wl = spec.workload(name)
    return config(wl["config"]), PARAMS[wl["traffic"]]
