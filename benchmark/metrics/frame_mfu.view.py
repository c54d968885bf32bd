"""The whole frame's share of the chip's float32 peak, in %: the operations a
frame needs (K1's counted operations, the projection's per Gaussian and the
argmax's CH − 1 compares a pixel, counted from the traced frames' inputs,
whatever implements them) over the mean frame time of the window times
67 TFLOP/s."""

from benchmark.harness import roofline


def read(ctx):
    work, w = ctx["work"], ctx["window"]
    if not work:
        return None
    ops = sum(roofline.blend_ops(x) + roofline.PROJECT_OPS * x["gaussians"]
              + (x["channels"] - 1) * x["pixels"] for x in work) / len(work)
    frame_s = w["window_s"] / w["count"]
    return 100.0 * ops / (frame_s * roofline.PEAK_FP32_FLOPS)
