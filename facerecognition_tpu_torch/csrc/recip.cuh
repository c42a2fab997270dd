// A correctly rounded reciprocal without a branch, shared by detect_post.cu
// and chi2_nn.cu.
#pragma once

// 1 / d, correctly rounded, for a normal d below 2^126 (so that 1 / d is
// normal too): an approximate reciprocal, one Newton step, and Markstein's
// correction, as the fast path of a division, without its branch to the
// slow path; the callers divide where d lies outside that range.
__device__ __forceinline__ float recip_normal(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  r = __fmaf_rn(r, __fmaf_rn(-d, r, 1.0f), r);
  return __fmaf_rn(__fmaf_rn(-d, r, 1.0f), r, r);
}
