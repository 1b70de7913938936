// The discrete diff of the Relief kernels: 1[a != b], added to a sum.
#pragma once

namespace fs {

// acc + v where a != b (unordered counts as not equal, as in C++), else
// acc: a compare and a predicated add, with no select.  acc + 0.0 would
// change no bit of a sum that is not -0.0, so pass 1 stays equal to a
// plain version that adds 1.0 or 0.0.
__device__ __forceinline__ float add_ne(float acc, float a, float b,
                                        float v) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.neu.f32 p, %1, %2;\n\t"
      "@p add.rn.f32 %0, %0, %3;\n\t}"
      : "+f"(acc)
      : "f"(a), "f"(b), "f"(v));
  return acc;
}

}  // namespace fs
