// Bit-packed (SWAR) Game of Life for Hopper, called from JAX through the
// XLA FFI (ops/cuda_ffi.py). Same carry-save adder logic as the jnp form
// in ops/gol_bits.py (_gen_from_neighbors): word P[w][c] bit b holds cell
// (32w + b, c) of the torus.
//
// A block loads its tile of the packed grid plus a halo into shared
// memory and runs `gens` generations there, ping-ponging between two
// buffers. The halo is loaded torus-wrapped from the grid and the tile's
// outside reads as dead cells, whose error travels one cell per
// generation and never reaches the interior (halo >= gens in both axes).
// Only the interior is written back.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 16;

__device__ __forceinline__ void vsum(uint32_t a, uint32_t p, uint32_t b,
                                     uint32_t& s0, uint32_t& s1) {
  uint32_t up = (p << 1) | (a >> 31);
  uint32_t down = (p >> 1) | (b << 31);
  s0 = up ^ p ^ down;
  s1 = (up & p) | (down & (up ^ p));
}

__device__ __forceinline__ uint32_t gen_word(
    uint32_t aL, uint32_t aC, uint32_t aR, uint32_t pL, uint32_t pC,
    uint32_t pR, uint32_t bL, uint32_t bC, uint32_t bR) {
  uint32_t l0, l1, s0, s1, r0, r1;
  vsum(aL, pL, bL, l0, l1);
  vsum(aC, pC, bC, s0, s1);
  vsum(aR, pR, bR, r0, r1);
  uint32_t b0 = l0 ^ s0 ^ r0;
  uint32_t c0 = (l0 & s0) | (r0 & (l0 ^ s0));
  uint32_t sa = l1 ^ s1, ca = l1 & s1;
  uint32_t sb = r1 ^ c0, cb = r1 & c0;
  uint32_t b1 = sa ^ sb, c2 = sa & sb;
  uint32_t b2 = ca ^ cb ^ c2;
  uint32_t b3 = (ca & cb) | (c2 & (ca ^ cb));
  uint32_t eq3 = b0 & b1 & ~(b2 | b3);
  uint32_t eq4 = b2 & ~(b0 | b1 | b3);
  return eq3 | (pC & eq4);
}

__device__ __forceinline__ int wrap_idx(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__global__ void gol_swar_kernel(const uint32_t* __restrict__ in,
                                uint32_t* __restrict__ out, int wn, int cn,
                                int bw, int cw, int hw, int hc, int gens) {
  extern __shared__ uint32_t smem[];
  const int th = bw + 2 * hw, tw = cw + 2 * hc;
  uint32_t* src = smem;
  uint32_t* dst = smem + th * tw;
  const int w0 = blockIdx.y * bw - hw;
  const int c0 = blockIdx.x * cw - hc;

  for (int r = threadIdx.y; r < th; r += blockDim.y) {
    const int gw = wrap_idx(w0 + r, wn);
    for (int c = threadIdx.x; c < tw; c += blockDim.x) {
      src[r * tw + c] = in[(size_t)gw * cn + wrap_idx(c0 + c, cn)];
    }
  }
  __syncthreads();

  for (int g = 0; g < gens; ++g) {
    for (int r = threadIdx.y; r < th; r += blockDim.y) {
      const bool has_a = r > 0, has_b = r < th - 1;
      const uint32_t* rowA = src + (has_a ? r - 1 : r) * tw;
      const uint32_t* rowP = src + r * tw;
      const uint32_t* rowB = src + (has_b ? r + 1 : r) * tw;
      for (int c = threadIdx.x; c < tw; c += blockDim.x) {
        const int cl = c - 1, cr = c + 1;
        const bool has_l = c > 0, has_r = c < tw - 1;
        const uint32_t pC = rowP[c];
        const uint32_t pL = has_l ? rowP[cl] : 0u;
        const uint32_t pR = has_r ? rowP[cr] : 0u;
        const uint32_t aC = has_a ? rowA[c] : 0u;
        const uint32_t aL = (has_a && has_l) ? rowA[cl] : 0u;
        const uint32_t aR = (has_a && has_r) ? rowA[cr] : 0u;
        const uint32_t bC = has_b ? rowB[c] : 0u;
        const uint32_t bL = (has_b && has_l) ? rowB[cl] : 0u;
        const uint32_t bR = (has_b && has_r) ? rowB[cr] : 0u;
        dst[r * tw + c] = gen_word(aL, aC, aR, pL, pC, pR, bL, bC, bR);
      }
    }
    __syncthreads();
    uint32_t* t = src;
    src = dst;
    dst = t;
  }

  for (int r = threadIdx.y; r < bw; r += blockDim.y) {
    const size_t row = (size_t)(blockIdx.y * bw + r) * cn;
    for (int c = threadIdx.x; c < cw; c += blockDim.x) {
      out[row + blockIdx.x * cw + c] = src[(r + hw) * tw + (c + hc)];
    }
  }
}

cudaError_t launch(cudaStream_t stream, const uint32_t* in, uint32_t* out,
                   int wn, int cn, int bw, int cw, int hw, int hc, int gens) {
  const int th = bw + 2 * hw, tw = cw + 2 * hc;
  const size_t smem = 2 * sizeof(uint32_t) * (size_t)th * tw;
  cudaError_t err = cudaFuncSetAttribute(
      gol_swar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(cn / cw, wn / bw);
  dim3 block(kBlockX, kBlockY);
  gol_swar_kernel<<<grid, block, smem, stream>>>(
      in, out, wn, cn, bw, cw, hw, hc, gens);
  return cudaGetLastError();
}

ffi::Error GolSwarImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> in,
                       ffi::ResultBuffer<ffi::U32> out,
                       ffi::ResultBuffer<ffi::U32> scratch, int64_t gens,
                       int64_t bw, int64_t cw, int64_t kk) {
  auto dims = in.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("need a 2-D grid");
  const int wn = static_cast<int>(dims[0]);
  const int cn = static_cast<int>(dims[1]);
  if (bw <= 0 || cw <= 0 || kk <= 0 || wn % bw || cn % cw) {
    return ffi::Error::InvalidArgument("plan does not tile the grid");
  }
  const uint32_t* src = in.typed_data();
  uint32_t* o = out->typed_data();
  uint32_t* s = scratch->typed_data();
  cudaError_t err = cudaSuccess;
  if (gens <= 0) {
    err = cudaMemcpyAsync(o, src, sizeof(uint32_t) * (size_t)wn * cn,
                          cudaMemcpyDeviceToDevice, stream);
  } else {
    const int hw = (int)((kk + 31) / 32);
    const int hc = (int)kk;
    const int64_t n = (gens + kk - 1) / kk;
    int64_t left = gens;
    for (int64_t i = 0; i < n && err == cudaSuccess; ++i) {
      // Alternate buffers so that the last launch writes `out`.
      uint32_t* dst = ((n - 1 - i) % 2 == 0) ? o : s;
      const int g = (int)(left < kk ? left : kk);
      err = launch(stream, src, dst, wn, cn, (int)bw, (int)cw, hw, hc, g);
      left -= g;
      src = dst;
    }
  }
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(RustexpGolSwar, GolSwarImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int64_t>("gens")
                                  .Attr<int64_t>("bw")
                                  .Attr<int64_t>("cw")
                                  .Attr<int64_t>("kk"));
