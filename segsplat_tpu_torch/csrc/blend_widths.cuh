// The channel widths the blend kernels are built for, the one place they are
// written: ops/blend.py reads KERNEL_WIDTHS and PACKED_WIDTHS from these two
// lines, and its wrappers pad any other CH up to the next width with zero
// colours (and, for K2, zero cotangents). K1 and K2 take CH <= 120 and K3 CH
// <= 56, as the TPU kernels do.
#pragma once

#define SEGSPLAT_WIDTHS(X) X(4) X(8) X(16) X(19) X(24) X(32) X(51) X(64) X(96) X(120)
#define SEGSPLAT_PACKED_WIDTHS(X) X(4) X(8) X(16) X(19) X(24) X(32) X(51) X(56)
