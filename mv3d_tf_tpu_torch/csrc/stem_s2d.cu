// Fused space-to-depth VGG stem: conv1_1 + ReLU + conv1_2 + ReLU + pool1 in
// one pass, NHWC, float32 or bf16 operands, float32 sums and biases.
//
// Replaces two TPU kernels, which compute one function:
//   mv3d_tf_tpu/ops/stem_s2d_pallas.py:stem_s2d_fused (pl.pallas_call at
//     :224), through ops/stem_s2d_cuda.py, in float32 and bf16;
//   mv3d_tf_tpu/ops/vgg_stem_pallas.py:vgg_stem_pallas (:106), the literal
//     stem of the bf16 detectors, through ops/vgg_stem_cuda.py, bf16.
// Both follow one rounding rule: the intermediate y = relu(conv1_1(x) + b1)
// is summed and biased in float32, zeroed where it falls outside the image
// (conv1_2's SAME padding: stem_s2d_pallas.py:171-184,
// vgg_stem_pallas.py:131-147), and rounded ONCE to the io type; then
// z = conv1_2(y) is summed in float32, relu(z + b2) taken with b2 in float32
// and the 2x2 VALID max pool (an odd last row or column dropped) rounded
// once to the io type. Both take NHWC x with Cin <= 16 and 64-wide convs.
//
// The TPU kernel packs 2x2 pixel blocks into 256 channels so that conv1_1
// becomes a 4x4 stride-2 dot and conv1_2 four shifted 256x256 dots, which
// fill its 128-wide matrix unit; 7 in 16 of their multiply-adds are by the
// packing's structural zeros. Every nonzero product of the packed dots is
// one product of the literal 3x3 convs, so both instances here sum the
// literal products (1/1.78 of the packed operations) and get the same sums
// up to their order. The four subpixel groups of a packed block are the
// four conv1_2 pixels under one pool window.
//
// What bounds it on this card: arithmetic. conv1_2 is 64x64x9 multiply-adds
// per full-resolution pixel (13.3 G per 601x601 frame), against ~0.3 bytes
// of input and output per multiply-add.
//
// bf16 instance (both TPU kernels' bf16 path: every bf16 detector's stem),
// on the tensor cores:
//   * mma.sync m16n8k16 bf16 with float32 accumulators, operands from
//     shared memory by ldmatrix. The earlier design ran float32 FMAs on
//     the CUDA cores, 2.6x behind cuDNN.
//   * Persistent blocks, one per SM, each holding all of conv1_2's weights
//     (576 x 64 bf16, 72 KB, stored output-channel major with a 1168-byte
//     row stride) and conv1_1's for the whole run, and walking over pooled
//     8 x 16 tiles.
//   * conv1_1 as an implicit GEMM: M = the 18 x 34 conv1_1 tile (the tile's
//     conv1_2 pixels and a 1-pixel halo, 1.2x the pixels conv1_2 needs),
//     N = 64, K = the (tap, channel) pairs packed without per-tap padding,
//     9 * Cin rounded up to 16 (96 for the BEV's 9 channels, 32 for the
//     image's 3). A fragments are gathered from the 20 x 36 input tile
//     through a table of (tap, channel) offsets. The float32 sums take b1,
//     ReLU and the edge mask and are rounded once into the y tile.
//   * conv1_2 as an implicit GEMM: M = the tile's 16 x 32 conv1_2 pixels,
//     N = 64, K = 576; the A operand of each tap is the y tile shifted by
//     one row offset. Eight warps, each 64 pixels x 64 channels (128 float32
//     accumulators a thread). Rows are ordered so that the four conv1_2
//     pixels under a pool window land in one thread's rows g and g + 8 of
//     two adjacent m-tiles: the 2x2 max stays in registers, then b2, ReLU,
//     one rounding and one store.
//   * The y tile keeps even columns before odd ones in each row, with a
//     144-byte pixel stride, so that ldmatrix's stride-2 pixel rows hit
//     distinct banks.
//
// float32 instance (kept from the first port; it must stay within 1e-5 of
// the max, so it keeps float32 math on the CUDA cores): one block per 8x8
// tile of pooled outputs stages the 20x20 input tile with its 2-pixel halo
// and conv1_1's weights, computes conv1_1's 18x18 output tile into shared
// memory, then streams conv1_2's weights 16 input channels at a time. Each
// thread owns one pooled pixel x 8 output channels and pools in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kC = 64;                  // stem width (C1 = C2)
constexpr int kCinP = 16;               // input channels, padded (MAX_CIN)

// ---------------------------------------------------------------------------
// float32 instance: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTP = 8;                  // pooled outputs per tile edge
constexpr int kTY = 2 * kTP + 2;        // conv1_1 tile edge (1-pixel halo)
constexpr int kTX = 2 * kTP + 4;        // input tile edge (2-pixel halo)
constexpr int kKC = 16;                 // conv1_2 input channels per slice
constexpr int kThreads = kTP * kTP * 8; // (pooled pixel, 8-channel group)
constexpr int kYS = kC + 4;             // y pixel stride: 272 B

constexpr int kXElems = kTX * kTX * kCinP;
constexpr int kW1Elems = 9 * kCinP * kC;
constexpr int kW2Slice = 9 * kKC * kC;
// the staging region holds the input tile and conv1_1's weights, then one
// slice of conv1_2's weights at a time
constexpr int kStage = kXElems + kW1Elems;
static_assert(kStage >= kW2Slice, "a conv1_2 weight slice must fit");
constexpr int kF32Smem = (kStage + kTY * kTY * kYS) * (int)sizeof(float);

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// 16-byte copy of n floats, global -> shared
__device__ __forceinline__ void copy16(float* dst, const float* src, int n,
                                       int t) {
  for (int i = t; i < n / 4; i += kThreads)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
}

// x (B,H,W,Cin); w1 (3,3,kCinP,64) HWIO, zero past Cin; w2 (3,3,64,64)
// HWIO; b1, b2 (64,); out (B,H/2,W/2,64); all float32.
__global__ void __launch_bounds__(kThreads, 1)
    stem_s2d_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w1,
                        const float* __restrict__ b1,
                        const float* __restrict__ w2,
                        const float* __restrict__ b2, float* __restrict__ out,
                        int H, int W, int Cin) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stage = reinterpret_cast<float*>(smem_raw);
  float* xs = stage;
  float* w1s = stage + kXElems;
  float* w2s = stage;
  float* ys = stage + kStage;

  const int Ho = H / 2, Wo = W / 2;
  const int n = blockIdx.z;
  const int py0 = blockIdx.y * kTP, px0 = blockIdx.x * kTP;
  const int t = threadIdx.x;
  const int co0 = (t & 7) * 8;
  const int gy0 = 2 * py0 - 2, gx0 = 2 * px0 - 2;  // input pixel at xs[0]

  copy16(w1s, w1, kW1Elems, t);
  // input tile; zero outside the image (conv1_1's SAME padding) and past Cin
  const float* xn = x + (size_t)n * H * W * Cin;
  for (int i = t; i < kXElems; i += kThreads) {
    const int c = i % kCinP, p = i / kCinP;
    const int gy = gy0 + p / kTX, gx = gx0 + p % kTX;
    float v = 0.0f;
    if (c < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = xn[((size_t)gy * W + gx) * Cin + c];
    xs[i] = v;
  }
  __syncthreads();

  // y = relu(conv1_1 + b1), 0 outside the image (the edge mask); ys[0] is
  // conv1_1 output pixel (gy0 + 1, gx0 + 1)
  for (int p = t >> 3; p < kTY * kTY; p += kThreads / 8) {
    const int yy = p / kTY, yx = p % kTY;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int u = 0; u < 3; ++u) {
      for (int v = 0; v < 3; ++v) {
        const float* xp = xs + ((yy + u) * kTX + (yx + v)) * kCinP;
        const float* wp = w1s + (u * 3 + v) * kCinP * kC + co0;
        for (int c = 0; c < Cin; ++c) {
          const float xv = xp[c];
          float wv[8];
          load8(wp + c * kC, wv);
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] = fmaf(xv, wv[k], acc[k]);
        }
      }
    }
    const int gy = gy0 + 1 + yy, gx = gx0 + 1 + yx;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      acc[k] = inside ? fmaxf(acc[k] + b1[co0 + k], 0.0f) : 0.0f;
    store8(ys + p * kYS + co0, acc);
  }

  // conv1_2 for the 2x2 pixels under this thread's pool window, conv1_2's
  // weights streamed through the staging region kKC input channels a time
  const int pp = t >> 3;
  const int ppy = pp / kTP, ppx = pp % kTP;
  float acc[4][8];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[q][k] = 0.0f;
  for (int s = 0; s < kC / kKC; ++s) {
    __syncthreads();   // ys complete; the staging region is free
    for (int tap = 0; tap < 9; ++tap)
      copy16(w2s + tap * kKC * kC, w2 + (tap * kC + s * kKC) * kC, kKC * kC,
             t);
    __syncthreads();
    for (int u = 0; u < 3; ++u) {
      for (int v = 0; v < 3; ++v) {
        const float* yb =
            ys + ((2 * ppy + u) * kTY + (2 * ppx + v)) * kYS + s * kKC;
        const float* wb = w2s + (u * 3 + v) * kKC * kC + co0;
#pragma unroll 4
        for (int ci = 0; ci < kKC; ci += 2) {
          float wa[8], wc[8];
          load8(wb + ci * kC, wa);
          load8(wb + (ci + 1) * kC, wc);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 yv = *reinterpret_cast<const float2*>(
                yb + ((q >> 1) * kTY + (q & 1)) * kYS + ci);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              acc[q][k] = fmaf(yv.x, wa[k], acc[q][k]);
              acc[q][k] = fmaf(yv.y, wc[k], acc[q][k]);
            }
          }
        }
      }
    }
  }
  // relu(z + b2) and the max over the four subpixels; rounding and the
  // bias add are monotone, so pooling the sums first gives the same bits
  const int py = py0 + ppy, px = px0 + ppx;
  if (py < Ho && px < Wo) {
    float r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float m = fmaxf(fmaxf(acc[0][k], acc[1][k]),
                            fmaxf(acc[2][k], acc[3][k]));
      r[k] = fmaxf(m + b2[co0 + k], 0.0f);
    }
    store8(out + (((size_t)n * Ho + py) * Wo + px) * kC + co0, r);
  }
}

// ---------------------------------------------------------------------------
// bf16 instance: tensor cores
// ---------------------------------------------------------------------------

constexpr int kPY = 8, kPX = 16;          // pooled tile
constexpr int kZY = 2 * kPY, kZX = 2 * kPX;   // conv1_2 tile: 16 x 32
constexpr int kYY = kZY + 2, kYX = kZX + 2;   // conv1_1 tile: 18 x 34
constexpr int kXY = kZY + 4, kXX = kZX + 4;   // input tile: 20 x 36
constexpr int kYPix = kYY * kYX;              // 612
constexpr int kYMTiles = (kYPix + 15) / 16;   // 39 m16 tiles of conv1_1
constexpr int kYHalf = kYX / 2;               // 17: odd columns' offset
constexpr int kBYS = kC + 8;                  // y pixel stride: 144 B
constexpr int kW2K = 9 * kC;                  // 576
constexpr int kW2S = kW2K + 8;                // w2 row stride: 1168 B
constexpr int kTCThreads = 256;               // 8 warps

static_assert(kZY / 2 == 8, "one pooled tile row per warp");

template <int KS>   // conv1_1's K steps of 16: K1 = 16 * KS >= 9 * Cin
struct TcLayout {
  static constexpr int K1 = 16 * KS;
  static constexpr int W1S = K1 + 8;          // w1 row stride (odd 16 B)
  static constexpr int w2 = 0;                                  // bf16
  static constexpr int ys = w2 + kC * kW2S * 2;                 // bf16
  static constexpr int w1 = ys + kYPix * kBYS * 2;              // bf16
  static constexpr int xs = w1 + kC * W1S * 2;                  // bf16
  static constexpr int koff = xs + kXY * kXX * kCinP * 2;       // int
  static constexpr int bias = koff + K1 * 4;                    // float x 128
  static constexpr int bytes = bias + 2 * kC * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return pack2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// y-tile pixel (row, col) -> its slot: even columns first, then odd
__device__ __forceinline__ int yslot(int row, int col) {
  return row * kYX + (col & 1) * kYHalf + (col >> 1);
}

// x (B,H,W,Cin) bf16; w1 (3,3,kCinP,64) bf16 HWIO, zero past Cin; w2
// (3,3,64,64) bf16 HWIO; b1, b2 (64,) float32; out (B,H/2,W/2,64) bf16;
// w1 and w2 16-byte aligned.
template <int KS>
__global__ void __launch_bounds__(kTCThreads, 1)
    stem_s2d_bf16_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ w1,
                         const float* __restrict__ b1,
                         const bf16* __restrict__ w2,
                         const float* __restrict__ b2, bf16* __restrict__ out,
                         int B, int H, int W, int Cin) {
  typedef TcLayout<KS> L;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* w2s = reinterpret_cast<bf16*>(smem + L::w2);
  bf16* ys = reinterpret_cast<bf16*>(smem + L::ys);
  bf16* w1s = reinterpret_cast<bf16*>(smem + L::w1);
  bf16* xs = reinterpret_cast<bf16*>(smem + L::xs);
  int* koff = reinterpret_cast<int*>(smem + L::koff);
  float* b1s = reinterpret_cast<float*>(smem + L::bias);
  float* b2s = b1s + kC;

  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int K1 = 9 * Cin;

  // weights, once per block, output channel major with K contiguous: one
  // 16-byte load brings eight output channels of one k, and the loop keeps
  // several loads in flight (a block at B=1 walks only 6-8 tiles)
#pragma unroll 6
  for (int i = t; i < kW2K * kC / 8; i += kTCThreads) {  // i = k * 8 + n / 8
    const uint4 v = reinterpret_cast<const uint4*>(w2)[i];
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    const int k = i >> 3, n = (i & 7) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) w2s[(n + j) * kW2S + k] = e[j];
  }
#pragma unroll 4
  for (int i = t; i < L::K1 * kC / 8; i += kTCThreads) {
    const int k = i >> 3, n = (i & 7) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k < K1)
      v = *reinterpret_cast<const uint4*>(
          w1 + ((k / Cin) * kCinP + k % Cin) * kC + n);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) w1s[(n + j) * L::W1S + k] = e[j];
  }
  // input-tile offset of each (tap, channel) of conv1_1's K; padding K
  // points at the pixel's own first value, times a zero weight
  for (int k = t; k < L::K1; k += kTCThreads) {
    const int tap = k / Cin;
    koff[k] = k < K1 ? ((tap / 3) * kXX + tap % 3) * Cin + k % Cin : 0;
  }
  if (t < kC) {
    b1s[t] = b1[t];
    b2s[t] = b2[t];
  }

  const int Ho = H / 2, Wo = W / 2;
  const int tx_n = (Wo + kPX - 1) / kPX, ty_n = (Ho + kPY - 1) / kPY;
  const int tiles = B * ty_n * tx_n;

  // ldmatrix row of this lane: m-tile row lr, K half lk
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lk = (lane >> 4) * 8;
  // B fragments: n row of this lane for n-tile pair np: 16 np + lb
  const int lb = (lane & 7) + (lane >> 4) * 8;
  const int lbk = ((lane >> 3) & 1) * 8;
  const uint32_t w2_lane = smem_u32(w2s + lb * kW2S + lbk);
  const uint32_t w1_lane = smem_u32(w1s + lb * L::W1S + lbk);
  const uint32_t ys_u32 = smem_u32(ys);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % tx_n;
    const int ty = (tile / tx_n) % ty_n;
    const int n = tile / (tx_n * ty_n);
    const int py0 = ty * kPY, px0 = tx * kPX;
    const int gy0 = 2 * py0 - 2, gx0 = 2 * px0 - 2;  // input pixel at xs[0]

    // input tile, zero outside the image (conv1_1's SAME padding); the
    // previous tile's conv1_1 is done with it (barrier after conv1_1)
    const bf16* xn = x + (size_t)n * H * W * Cin;
#pragma unroll 4
    for (int i = t; i < kXY * kXX * Cin; i += kTCThreads) {
      const int p = i / Cin, c = i - p * Cin;
      const int gy = gy0 + p / kXX, gx = gx0 + p % kXX;
      bf16 v = __float2bfloat16_rn(0.0f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = xn[((size_t)gy * W + gx) * Cin + c];
      xs[i] = v;
    }
    __syncthreads();   // xs ready; the previous tile's conv1_2 left ys

    // conv1_1: y = relu(x (*) w1 + b1), 0 outside the image, rounded once;
    // y-tile pixel (yy, yx) is conv1_1 output pixel (gy0 + 1 + yy, ...)
    for (int mt = warp; mt < kYMTiles; mt += kTCThreads / 32) {
      int base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = min(16 * mt + g + 8 * h, kYPix - 1);
        base[h] = ((p / kYX) * kXX + p % kYX) * Cin;
      }
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int k = 16 * s + 2 * t4;
        const int o0 = koff[k], o1 = koff[k + 1];
        const int o2 = koff[k + 8], o3 = koff[k + 9];
        uint32_t a[4];
        a[0] = pack2(xs[base[0] + o0], xs[base[0] + o1]);
        a[1] = pack2(xs[base[1] + o0], xs[base[1] + o1]);
        a[2] = pack2(xs[base[0] + o2], xs[base[0] + o3]);
        a[3] = pack2(xs[base[1] + o2], xs[base[1] + o3]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldsm_x4(b, w1_lane + (np * 16 * L::W1S + 16 * s) * 2);
          mma_bf16(acc[2 * np], a, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * mt + g + 8 * h;
        if (p >= kYPix) continue;
        const int yy = p / kYX, yx = p % kYX;
        const int gy = gy0 + 1 + yy, gx = gx0 + 1 + yx;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        bf16* yp = ys + yslot(yy, yx) * kBYS + 2 * t4;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * t4;
          const float v0 =
              inside ? fmaxf(acc[j][2 * h] + b1s[c], 0.0f) : 0.0f;
          const float v1 =
              inside ? fmaxf(acc[j][2 * h + 1] + b1s[c + 1], 0.0f) : 0.0f;
          *reinterpret_cast<uint32_t*>(yp + 8 * j) = pack2f(v0, v1);
        }
      }
    }
    __syncthreads();   // ys ready; xs free for the next tile

    // conv1_2: warp w owns pooled row w of the tile, 16 pooled pixels as
    // two groups q of 8; m-tile 2q + j holds conv1_2 column 2 px + j, its
    // row r < 8 at conv1_2 row 2w, r >= 8 at row 2w + 1, pooled px 8q + r%8
    float acc[4][8][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    const int cy = 2 * warp + (lr >> 3);     // this lane's ldmatrix row
#pragma unroll
    for (int du = 0; du < 3; ++du) {
#pragma unroll
      for (int dv = 0; dv < 3; ++dv) {
        uint32_t arow[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // column of y: 2 (8q + r%8) + j + dv, slot of its parity half
          const int e = (i & 1) + dv;
          const int px = 8 * (i >> 1) + (lr & 7);
          arow[i] = ys_u32 + (((cy + du) * kYX + (e & 1) * kYHalf + px +
                               (e >> 1)) * kBYS + lk) * 2;
        }
        const int tap = du * 3 + dv;
#pragma unroll
        for (int kc = 0; kc < kC / 16; ++kc) {
          uint32_t a[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) ldsm_x4(a[i], arow[i] + kc * 32);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            ldsm_x4(b, w2_lane + (np * 16 * kW2S + tap * kC + kc * 16) * 2);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              mma_bf16(acc[i][2 * np], a[i], b[0], b[1]);
              mma_bf16(acc[i][2 * np + 1], a[i], b[2], b[3]);
            }
          }
        }
      }
    }

    // pool: rows g, g + 8 of m-tiles 2q and 2q + 1 are the window of pooled
    // pixel (w, 8q + g); max first, then b2 and ReLU (monotone, same bits),
    // one rounding, one store
    const int py = py0 + warp;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int px = px0 + 8 * q + g;
      if (py >= Ho || px >= Wo) continue;
      bf16* op = out + (((size_t)n * Ho + py) * Wo + px) * kC + 2 * t4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t4;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float m = fmaxf(
              fmaxf(acc[2 * q][j][e], acc[2 * q][j][e + 2]),
              fmaxf(acc[2 * q + 1][j][e], acc[2 * q + 1][j][e + 2]));
          v[e] = fmaxf(m + b2s[c + e], 0.0f);
        }
        *reinterpret_cast<uint32_t*>(op + 8 * j) = pack2f(v[0], v[1]);
      }
    }
  }
}

template <int KS>
int launch_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, void* out, int B, int H, int W, int Cin,
                void* stream) {
  constexpr int smem = TcLayout<KS>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      stem_s2d_bf16_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int Ho = H / 2, Wo = W / 2;
  const long long tiles = (long long)B * ((Ho + kPY - 1) / kPY) *
                          ((Wo + kPX - 1) / kPX);
  const int grid = (int)(tiles < sms ? tiles : sms);
  stem_s2d_bf16_kernel<KS><<<grid, kTCThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (bf16*)out, B, H, W, Cin);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mv3d_stem_s2d_f32(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* out,
                                 int B, int H, int W, int Cin, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stem_s2d_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kF32Smem);
  if (err != cudaSuccess) return (int)err;
  const int Ho = H / 2, Wo = W / 2;
  dim3 grid((Wo + kTP - 1) / kTP, (Ho + kTP - 1) / kTP, B);
  stem_s2d_f32_kernel<<<grid, kThreads, kF32Smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w1, (const float*)b1, (const float*)w2,
      (const float*)b2, (float*)out, H, W, Cin);
  return (int)cudaGetLastError();
}

// K steps of conv1_1 for Cin: 9 * Cin rounded up to 16, in three sizes
extern "C" int mv3d_stem_s2d_bf16(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, int B, int H,
                                  int W, int Cin, void* stream) {
  const int ks = (9 * Cin + 15) / 16;
  if (ks <= 2)
    return launch_bf16<2>(x, w1, b1, w2, b2, out, B, H, W, Cin, stream);
  if (ks <= 6)
    return launch_bf16<6>(x, w1, b1, w2, b2, out, B, H, W, Cin, stream);
  return launch_bf16<9>(x, w1, b1, w2, b2, out, B, H, W, Cin, stream);
}
