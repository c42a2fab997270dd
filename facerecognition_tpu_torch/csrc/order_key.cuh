// Scores ranked as lax.top_k ranks them, shared by stream_topk.cu and
// detect_post.cu: an int32 key of IEEE total order (-NaN < -inf < ... < -0 <
// +0 < ... < +inf < +NaN), every NaN of one sign on one key, so NaNs tie
// among themselves and go lowest index first. ops/matcher.order_key computes
// the same keys in PyTorch. INT_MIN is below every score's key.
#pragma once

#include <climits>

__device__ __forceinline__ int order_key(float s) {
  const int b = __float_as_int(s);
  if (s != s) return b >= 0 ? INT_MAX : -INT_MAX;
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}

// The score of a key (NaNs come back as one NaN of their sign).
__device__ __forceinline__ float key_score(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7FFFFFFF);
}
