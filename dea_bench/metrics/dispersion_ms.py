"""dispersion_ms: device milliseconds a study of the kernels launched by
the main pass's dispersion stages (the genewise pass with its mu init and
MLE, and the MAP dispersions), outside the Cook's refit."""

SPANS = (
    "pydeseq2_tpu_torch.fused_stream._genewise_pass",
    "pydeseq2_tpu_torch.fused_stream._shrunk_dispersions",
    "pydeseq2_tpu_torch.fused_stream._apply_streamed_refit",
)
COUNTS = ()


def read(tr):
    if not tr.studies:
        return None
    t = tr.span_device_s(("fused_stream._genewise_pass", "fused_stream._shrunk_dispersions"),
                         exclude=("fused_stream._apply_streamed_refit",))
    return 1e3 * t / tr.studies if t > 0 else None
