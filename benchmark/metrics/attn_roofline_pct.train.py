"""The window attention's least time from shapes (the model file's
``attn_bound_s_step``: QK^T and PV forward and backward at the bf16 peak,
or the bytes of q, k, v, o, the bias, the shift mask and their gradients
at the memory's bandwidth) times the window's steps, over the device
time of the attention kernels in the trace. The kernels are matched here
by name: PyTorch's memory-efficient attention forward and backward
(``fmha_cutlassF`` / ``fmha_cutlassB``), which ``kernel_classes.json``
leaves among the plain classes."""

MATCH = ("fmha_cutlass", "efficient_attention", "MemEffAttention")


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["steps"] or not ctx.get("attn_bound_s_step"):
        return None
    busy = sum(s for name, s in tr["by_class"].items()
               if any(p in name for p in MATCH))
    if busy <= 0:
        return None
    return 100.0 * ctx["attn_bound_s_step"] * ctx["steps"] / busy
