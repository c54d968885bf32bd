"""The whole train step's share of the chip's float32 peak, in %: the
operations a step needs, counted from the traced steps' inputs whatever
implements them, over the mean step time of the window times 67 TFLOP/s.

  * K1's and K2's counted operations (``roofline.blend_ops``);
  * the projection, forward and backward, of every row of the table;
  * per pixel (P = W·H): L1 forward and backward 20; SSIM's five blurred
    maps of 3 channels, 11 + 11 taps, forward and backward 2 000; the
    confidence map's 256 × 16 products and exponentials 8 700; the codebook
    logits, forward and their gradient 16 400; softmax, the virtual GT's
    sums and the gated cross-entropy, forward and backward 3 600; the norm
    regulariser 60: 30 780;
  * per contrastive sample: its 256 × 16 products and exponentials, forward
    and backward: 26 000.
"""

from benchmark.harness import roofline

PER_PIXEL = 30_780
PER_SAMPLE = 26_000


def read(ctx):
    work, w, cfg = ctx["work"], ctx["window"], ctx["config"]
    if not work:
        return None
    ops = sum(roofline.blend_ops(x, backward=True)
              + (roofline.PROJECT_OPS + roofline.PROJECT_BWD_OPS) * x["gaussians"]
              + PER_PIXEL * x["pixels"] + PER_SAMPLE * cfg["contrast_samples"]
              for x in work) / len(work)
    step_s = w["window_s"] / w["count"]
    return 100.0 * ops / (step_s * roofline.PEAK_FP32_FLOPS)
