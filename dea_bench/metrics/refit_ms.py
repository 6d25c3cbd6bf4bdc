"""refit_ms: device milliseconds a study of the kernels launched by the
Cook's refit (the gather, the refit tile with its own dispersion fits, the
merge and the adjusted p-values)."""

SPANS = ("pydeseq2_tpu_torch.fused_stream._apply_streamed_refit",)
COUNTS = ()


def read(tr):
    if not tr.studies:
        return None
    t = tr.span_device_s(("fused_stream._apply_streamed_refit",))
    return 1e3 * t / tr.studies if t > 0 else None
