"""sf_ms: device milliseconds a study of the kernels launched by the
iterative size factors (``fused_stream.iterative_size_factors``: every
round's MoM, genewise and MAP fits and its trimmed solve), the solve that
``run_summary_streamed`` switches to where every gene has a zero."""

SPANS = ("pydeseq2_tpu_torch.fused_stream.iterative_size_factors",)
COUNTS = ()


def read(tr):
    if not tr.studies:
        return None
    t = tr.span_device_s(("fused_stream.iterative_size_factors",))
    return 1e3 * t / tr.studies if t > 0 else None
