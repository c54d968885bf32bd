"""The whole view's share of the chip's float32 peak, in %: the operations a
view needs (K1's counted operations on the reference's rows and passing
pair-pixels at the P real channels, the projection's per Gaussian and the
argmax's P − 1 compares a pixel, counted on the traced views by
``reference/render.view_work``, whatever implements them) over the mean view
period of the window times 67 TFLOP/s."""

from benchmark.harness import roofline


def read(ctx):
    work, w = ctx["work"], ctx["window"]
    if not work:
        return None
    ops = sum(roofline.blend_ops(x) + roofline.PROJECT_OPS * x["gaussians"]
              + (x["channels"] - 1) * x["pixels"] for x in work) / len(work)
    return 100.0 * ops / (w["window_s"] / w["count"] * roofline.PEAK_FP32_FLOPS)
