"""analyse_ms: device milliseconds a study of the kernels launched by the
main pass's analysis (IRLS with its rescue, hat + Wald, the Cook's flags),
outside its MAP dispersions and outside the Cook's refit."""

SPANS = (
    "pydeseq2_tpu_torch.fused_stream._analyse_pass",
    "pydeseq2_tpu_torch.fused_stream._shrunk_dispersions",
    "pydeseq2_tpu_torch.fused_stream._apply_streamed_refit",
)
COUNTS = ()


def read(tr):
    if not tr.studies:
        return None
    t = tr.span_device_s(("fused_stream._analyse_pass",),
                         exclude=("fused_stream._shrunk_dispersions", "fused_stream._apply_streamed_refit"))
    return 1e3 * t / tr.studies if t > 0 else None
