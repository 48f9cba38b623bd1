// Brute-force closest hit over a packed face table, for NVIDIA Hopper
// (sm_90a).
//
// Replaces mitsuba_tpu/ops/pallas/intersect_pallas.py::intersect_packed
// (:125, Pallas kernel _kernel :51): for each ray, the closest face of a
// (9, F) table [p0 | e1 | e2] (pack_triangles) within 0 < t <= maxt,
// with its barycentrics.  The wavefront PathIntegrator queries it twice a
// depth on scenes of at most 1024 faces: closest hit, then shadow rays.
//
// What bounds it on this card: FP32 arithmetic.  Every active ray tests
// every face (about 53 floating-point operations a test) and moves 29
// bytes in and 16 out; at 36 faces that is ~1900 operations against 45
// bytes.  An inactive slot costs its 1-byte flag and 16 bytes of misses.
//
// Design: active-ray compaction in a persistent grid.
// - As many blocks as the card holds at once (SMs x resident blocks from
//   the occupancy calculator), each walking the ray slots in chunks of
//   CHUNK = SLOTS x THREADS slots, grid-strided: SLOTS rows of THREADS
//   slots, one slot of each row a thread, so flags load and misses store
//   coalesced.  A thread's SLOTS flags are loaded a chunk ahead, so a
//   block keeps SLOTS x THREADS flags in flight while it compacts and
//   traces: a sparse launch is mostly a stream of flags, paced by their
//   load latency.
// - In a chunk an inactive slot gets its miss (t = inf, prim = -1,
//   u = v = 0) written at once; the active ones append their slot ids to
//   a ring queue in shared memory, row after row, each at its offset from
//   one warp scan of the threads' per-row counts (packed 16 bits a row)
//   and a prefix over the warps.  The queue keeps slot order, so
//   neighbouring threads trace neighbouring rays.
// - While the queue holds THREADS rays (or the slots have run out),
//   every thread takes one of them: warps sweep the faces with every
//   thread on a live ray, wherever the inactive slots lie.  (Two or four
//   rays a thread, sharing each face row, ran slower on an H100: their
//   registers cost resident blocks.)
// - A block stages the faces before its first batch, one 12-float row a
//   face [p0 | e1 | e2 | 0 0 0] read as three 128-bit broadcasts; a block
//   that meets no active ray stages nothing, so a launch without one only
//   writes misses.
// - The test is csrc/path_common.cuh's tri_test<true>, built with
//   -fmad=false, and the tie rule is the TPU kernel's, which reduces each
//   128-face block to its smallest t and keeps the LARGEST index among
//   equal t there, then keeps an earlier block's hit unless a later block
//   is strictly closer.  Swept face by face: face j replaces the best bj
//   if t < bt, or if t == bt and j and bj lie in one 128-face block.  So
//   every ray's (t, prim, u, v) is the one-thread-per-ray sweep's, bit for
//   bit, whichever thread takes it.

#include "path_common.cuh"
#include "brute_common.cuh"
#include "persistent.cuh"

namespace {

using namespace mk;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLOTS = 2;                 // flags a thread reads a chunk
constexpr int CHUNK = SLOTS * THREADS;   // ray slots a block compacts at once
constexpr int QUEUE = 2048;              // ring of queued slot ids
constexpr int T_BLOCK_SHIFT = 7;  // 128-face blocks of the tie rule

// Closest hit of ray i over every staged face, written to slot i.
__device__ __forceinline__ void trace_ray(
    const float4* geo, int n_faces, int i, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ maxt,
    float* __restrict__ t_out, int32_t* __restrict__ prim,
    float* __restrict__ u_out, float* __restrict__ v_out) {
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float mt = maxt[i];
  float bt = CUDART_INF_F, bu = 0.0f, bv = 0.0f;
  int bj = -1;
  for (int j = 0; j < n_faces; ++j) {
    float g[9], t, u, v;
    load_face(geo, j, g);
    if (tri_test<true>(g, ox, oy, oz, dx, dy, dz, mt, t, &u, &v) &&
        (t < bt ||
         (t == bt && (j >> T_BLOCK_SHIFT) == (bj >> T_BLOCK_SHIFT)))) {
      bt = t;
      bj = j;
      bu = u;
      bv = v;
    }
  }
  t_out[i] = bt;
  prim[i] = bj;
  u_out[i] = bu;
  v_out[i] = bv;
}

__global__ void __launch_bounds__(THREADS)
intersect_packed_kernel(const float* __restrict__ tris, int n_faces,
                        const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ maxt,
                        const uint8_t* __restrict__ active, int n,
                        float* __restrict__ t_out, int32_t* __restrict__ prim,
                        float* __restrict__ u_out, float* __restrict__ v_out) {
  // the queue holds fewer than THREADS rays before a chunk's appends
  static_assert(THREADS - 1 + CHUNK <= QUEUE && (QUEUE & (QUEUE - 1)) == 0,
                "the ring queue must hold a batch less one plus a chunk");
  extern __shared__ float4 geo[];  // 3 per face
  __shared__ int queue[QUEUE];
  __shared__ unsigned long long warp_count[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_chunks = (n + CHUNK - 1) / CHUNK;
  const int stride = gridDim.x * CHUNK;
  bool staged = false;
  int head = 0, tail = 0;  // queued: [head, tail), the same in every thread
  int first = blockIdx.x * CHUNK + threadIdx.x;  // this thread's row-0 slot
  bool next[SLOTS];  // the flags of the block's next chunk
#pragma unroll
  for (int k = 0; k < SLOTS; ++k)
    next[k] = first + k * THREADS < n && active[first + k * THREADS] != 0;
  for (int c = blockIdx.x;; c += gridDim.x, first += stride) {
    const bool more = c < n_chunks;
    if (more) {
      bool act[SLOTS];
      unsigned long long count = 0;  // active slots a row, 16 bits a row
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        const int i = first + k * THREADS;
        act[k] = next[k];
        count += (unsigned long long)act[k] << (16 * k);
        next[k] = i + stride < n && active[i + stride] != 0;
        if (i < n && !act[k]) {
          t_out[i] = CUDART_INF_F;
          prim[i] = -1;
          u_out[i] = 0.0f;
          v_out[i] = 0.0f;
        }
      }
      unsigned long long scan = count;  // inclusive over the warp, row by row
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned long long y = __shfl_up_sync(FULL_MASK, scan, off);
        if (lane >= off) scan += y;
      }
      if (lane == 31) warp_count[warp] = scan;
      __syncthreads();
      unsigned long long before = scan - count, total = 0;  // packed as count
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const unsigned long long cw = warp_count[w];
        before += w < warp ? cw : 0;
        total += cw;
      }
      int row = tail;  // where row k starts in the queue
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        if (act[k])
          queue[(row + (int)((before >> (16 * k)) & 0xffff)) & (QUEUE - 1)] =
              first + k * THREADS;
        row += (int)((total >> (16 * k)) & 0xffff);
      }
      tail = row;
      __syncthreads();  // the appends are visible; warp_count may be reused
    }
    while (tail - head >= THREADS || (!more && tail > head)) {
      if (!staged) {
        stage_face_rows(geo, tris, n_faces, 1, n_faces);
        __syncthreads();
        staged = true;
      }
      const int take = tail - head < THREADS ? tail - head : THREADS;
      const int i =
          threadIdx.x < take ? queue[(head + threadIdx.x) & (QUEUE - 1)] : -1;
      // no barrier: the next writes to these entries follow the next
      // chunk's first barrier
      head += take;
      if (i >= 0)
        trace_ray(geo, n_faces, i, o, d, maxt, t_out, prim, u_out, v_out);
    }
    if (!more) break;
  }
}

size_t smem_bytes(int n_faces) { return sizeof(float4) * 3 * (size_t)n_faces; }

// Fills `g` for a launch over n rays and, if `run`, launches.
cudaError_t launch(const float* tris, int n_faces, const float* o,
                   const float* d, const float* maxt, const uint8_t* active,
                   int n, float* t, int32_t* prim, float* u, float* v,
                   cudaStream_t stream, bool run, PersistentGrid& g) {
  const size_t smem = smem_bytes(n_faces);
  cudaError_t err = persistent_grid(intersect_packed_kernel, THREADS, smem,
                                    (n + CHUNK - 1) / CHUNK, g);
  if (err != cudaSuccess || !run) return err;
  intersect_packed_kernel<<<g.blocks, THREADS, smem, stream>>>(
      tris, n_faces, o, d, maxt, active, n, t, prim, u, v);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` over n rays; allocates nothing and does
// not synchronise.  tris is (9, n_faces) float32 with n_faces <= 1024;
// o, d (n, 3) and maxt (n,) float32; active (n,) bool.  Outputs (n,): t
// (inf on a miss or an inactive ray), prim (-1), u, v.  Returns the first
// CUDA error of the set-up or the launch.
extern "C" int intersect_packed(const float* tris, int n_faces,
                                const float* o, const float* d,
                                const float* maxt, const uint8_t* active,
                                int n, float* t, int32_t* prim, float* u,
                                float* v, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  PersistentGrid g;
  return (int)launch(tris, n_faces, o, d, maxt, active, n, t, prim, u, v,
                     (cudaStream_t)stream, true, g);
}

// The launch intersect_packed makes for these sizes, in cfg[0..4]:
// blocks, resident blocks per SM, threads a block (one queued ray each),
// SMs, ray slots a chunk.
extern "C" int intersect_packed_config(int n_faces, int n, int* cfg) {
  PersistentGrid g{0, 0, 0, 0};
  const cudaError_t err =
      n > 0 ? launch(nullptr, n_faces, nullptr, nullptr, nullptr, nullptr, n,
                     nullptr, nullptr, nullptr, nullptr, nullptr, false, g)
            : cudaSuccess;
  cfg[0] = g.blocks;
  cfg[1] = g.resident;
  cfg[2] = g.threads;
  cfg[3] = g.sms;
  cfg[4] = CHUNK;
  return (int)err;
}
