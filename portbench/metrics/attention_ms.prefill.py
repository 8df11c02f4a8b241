"""`attention_ms.prefill`: the device ms a call of the port's
`block.attention` spans (each layer's QKV product, RoPE, the flash
kernel and the output product): for each span, the busy union of the
device operations launched inside it, read from the trace; summed over
the layers and averaged over the window's whole cycles of lengths."""
from portbench.harness.spans import device_ms_a_call


def read(run):
    return device_ms_a_call(run, "block.attention")
