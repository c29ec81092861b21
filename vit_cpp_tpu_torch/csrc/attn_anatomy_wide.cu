// The T1 stage anatomy's variants whose score dot runs over the head
// group's lanes, nomask and onedot (attn_anatomy.cu describes them): 10 of
// its 28 instantiations, compiled beside attn_anatomy.cu by an nvcc of
// their own.

#include "attn_anatomy.cuh"

namespace anatomy {

// The score dot over the group's lanes: d = 64, the pair's two 64-lane
// boxes; else 8 slices up to 128 lanes, else 16.
cudaError_t nomask(const Args& a, cudaStream_t stream) {
  const attn::Group grp{a.group, a.group * a.d, 1, 0};
  if (a.d == attn::kWgD) return launch_wgmma<kNoMask, 8>(a, grp, stream);
  const bool wide = a.group * a.d > 128;
  if (a.d <= 64)
    return wide ? launch<kNoMask, 4, 16>(a, grp, stream) : launch<kNoMask, 4, 8>(a, grp, stream);
  return wide ? launch<kNoMask, 8, 16>(a, grp, stream) : launch<kNoMask, 8, 8>(a, grp, stream);
}

cudaError_t onedot(const Args& a, cudaStream_t stream) {
  const int width = a.onedot_sum ? a.group * a.d : a.d;
  const attn::Group grp{a.group, width, a.out_copies, (long long)a.nh * a.d};
  if (a.d == attn::kWgD)
    return width == 64 ? launch_wgmma<kOneDot, 4>(a, grp, stream)
                       : launch_wgmma<kOneDot, 8>(a, grp, stream);
  if (width <= 64) return launch<kOneDot, 4, 4>(a, grp, stream);
  if (width <= 128) return launch<kOneDot, 8, 8>(a, grp, stream);
  return launch<kOneDot, 16, 16>(a, grp, stream);
}

}  // namespace anatomy
