// Bounds-checked accesses: the checked build of the kernels (nvcc
// -DMCRAW_CHECKED, kernels/build.py's checked variant).
//
// The JAX package cannot read outside a frame's buffer (BlockSpecs and DMAs
// whose extents the grid fixes, clamped gathers); these kernels read global
// memory by address, and their guards are tested here. In the default build
// every macro below is the plain access it wraps, and the kernels, their
// arguments and their entry points are exactly what they are without it.
// In a checked build:
//
// - each entry point takes one more argument, a host pointer to an Args:
//   the address and byte extent of each global buffer the entry was given
//   (in the order of the kernel's `enum Buffer`), bytes to take off each
//   extent (a shared array's: off its true size) and off each batch frame's
//   window, and a device record of kRecordWords int64;
// - each kernel takes a Check by value and tests every global load, global
//   store, cp.async source and destination, TMA destination and
//   shared-memory index against the extent of its buffer. A violation adds
//   one to the record's count of its kind, fills the record's first-fault
//   fields once (kernel, entry, buffer, kind, byte index, extent, block,
//   thread) and skips the access: a skipped load reads 0. No __trap, which
//   would end the process's CUDA context and every later launch with it;
// - a batch frame's reads of its payload outside its own window
//   [bases[f], bases[f] + lengths[f]) but inside the buffer are counted
//   (kCrossFrame), not faulted: the kernels mask what such reads return;
// - the entry's own host reads (develop's parameters and tensor map),
//   host-issued stores (the memsets of the checksum and of the block
//   offsets' status scratch) and the reach of a TMA copy's tensor map (the
//   develop ring's, whose reads the map bounds) are checked against the
//   same extents into the host record of Args; develop then returns
//   without launching, the checksum skips its memset and launches, the
//   block offsets return without launching (their kernel would wait on
//   tile status words that were never zeroed);
// - a tile status word of the block offsets' look-back that faults reads
//   as a known prefix of 0, so a faulted load ends the look-back instead
//   of spinning on it.
//
// The wrapper (kernels/build.py::launch) waits for the launch, reads both
// records and raises on a fault.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// A 64-bit word read with acquire and written with release semantics at
// the scope of the card (csrc/block_offsets.cu's tile status words).
__device__ __forceinline__ unsigned long long mcraw_ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void mcraw_st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

#ifdef MCRAW_CHECKED

namespace mcraw_check {

constexpr int kMaxBuffers = 16;

enum Kernel : int { kUnpackModern = 0, kUnpackLegacy, kDevelop, kChecksum, kBlockOffsets };
enum Entry : int {
  kEntryUnpackModernBatch = 0,
  kEntryUnpackLegacyBatch,
  kEntryDevelop,
  kEntryChecksum,
  kEntryBlockOffsetsBatch,
  kEntryDevelopRing,
  kEntryDevelopRows,
  kEntryDevelopRowsRing,
};
enum Kind : int { kLoad = 0, kCpAsync, kStore, kShared, kHost, kKinds };
// The record: kRecordWords int64 (kernels/build.py RECORD).
enum Record : int {
  kFaults = 0,
  kKernel,
  kEntry,
  kBuffer,
  kKind,
  kIndex,   // byte offset of the access from the buffer's start
  kExtent,  // the extent it was held to, in bytes
  kBlockX,
  kBlockY,
  kThread,
  kByKind,  // kKinds counts
  kCrossFrame = kByKind + kKinds,
  kRecordWords,
};

// The entry's extra argument (host memory; kernels/build.py CheckArgs).
struct Args {
  int64_t addr[kMaxBuffers];
  int64_t bytes[kMaxBuffers];
  int64_t trim[kMaxBuffers];
  int64_t window_trim;
  int64_t record;  // device pointer to kRecordWords int64
  int64_t host[kRecordWords];
};

// The kernel's copy (by value).
struct Check {
  uint64_t addr[kMaxBuffers];
  int64_t bytes[kMaxBuffers];  // global buffers: the extent, trimmed
  int64_t trim[kMaxBuffers];   // shared arrays: bytes off their true size
  int64_t window_trim;
  unsigned long long* record;
  int kernel, entry;
  int window_buf;  // the buffer a batch frame's window lies in; -1: none
  uint64_t win_lo, win_hi;
};

inline Check make(const Args* a, int kernel, int entry) {
  Check c{};
  for (int i = 0; i < kMaxBuffers; ++i) {
    c.addr[i] = static_cast<uint64_t>(a->addr[i]);
    c.bytes[i] = a->bytes[i] - a->trim[i];
    c.trim[i] = a->trim[i];
  }
  c.window_trim = a->window_trim;
  c.record = reinterpret_cast<unsigned long long*>(a->record);
  c.kernel = kernel;
  c.entry = entry;
  c.window_buf = -1;
  return c;
}

// A fault of the entry's own, on the host: at byte `index` of buffer
// `buf`, held to `extent`.
inline void host_fault(Args* a, int kernel, int entry, int buf, int kind, int64_t index,
                       int64_t extent) {
  a->host[kByKind + kind] += 1;
  if (a->host[kFaults]++ == 0) {
    a->host[kKernel] = kernel;
    a->host[kEntry] = entry;
    a->host[kBuffer] = buf;
    a->host[kKind] = kind;
    a->host[kIndex] = index;
    a->host[kExtent] = extent;
    a->host[kBlockX] = a->host[kBlockY] = a->host[kThread] = -1;
  }
}

// A host-side access of `need` bytes at the start of buffer `buf`.
inline bool host_ok(Args* a, int kernel, int entry, int buf, int kind, int64_t need) {
  const int64_t extent = a->bytes[buf] - a->trim[buf];
  if (need <= extent) return true;
  host_fault(a, kernel, entry, buf, kind, need - 1, extent);
  return false;
}

__device__ inline void fault(const Check& c, int buf, int kind, int64_t index,
                             int64_t extent) {
  unsigned long long* r = c.record;
  atomicAdd(r + kByKind + kind, 1ull);
  if (atomicAdd(r + kFaults, 1ull) == 0ull) {
    r[kKernel] = c.kernel;
    r[kEntry] = c.entry;
    r[kBuffer] = buf;
    r[kKind] = kind;
    r[kIndex] = static_cast<unsigned long long>(index);
    r[kExtent] = static_cast<unsigned long long>(extent);
    r[kBlockX] = blockIdx.x;
    r[kBlockY] = blockIdx.y;
    r[kThread] = threadIdx.x + blockDim.x * threadIdx.y;
  }
}

// [p, p + n) inside global buffer `buf`; a read of the frame's window
// buffer outside the window is counted.
__device__ inline bool global_ok(const Check& c, int buf, const void* p, int64_t n,
                                 int kind) {
  const uint64_t a = reinterpret_cast<uint64_t>(p);
  const int64_t off = static_cast<int64_t>(a - c.addr[buf]);
  if (a < c.addr[buf] || off > c.bytes[buf] - n) {
    fault(c, buf, kind, off, c.bytes[buf]);
    return false;
  }
  if (buf == c.window_buf && kind != kStore && (a < c.win_lo || a + n > c.win_hi)) {
    atomicAdd(c.record + kCrossFrame, 1ull);
  }
  return true;
}

// [p, p + n) inside the first `size` - trim bytes of shared array `base`.
__device__ inline bool shared_ok(const Check& c, int id, const void* base, int64_t size,
                                 const void* p, int64_t n) {
  const int64_t off = static_cast<const char*>(p) - static_cast<const char*>(base);
  const int64_t extent = size - c.trim[id];
  if (off < 0 || off > extent - n) {
    fault(c, id, kShared, off, extent);
    return false;
  }
  return true;
}

template <class T>
__device__ inline T ld(const Check& c, int buf, const T* p, int64_t i) {
  return global_ok(c, buf, p + i, sizeof(T), kLoad) ? p[i] : T{};
}

template <class T>
__device__ inline T ldg(const Check& c, int buf, const T* p, int64_t i) {
  return global_ok(c, buf, p + i, sizeof(T), kLoad) ? __ldg(p + i) : T{};
}

template <class T, class V>
__device__ inline void st(const Check& c, int buf, T* p, int64_t i, V v) {
  if (global_ok(c, buf, p + i, sizeof(T), kStore)) p[i] = v;
}

template <class T, class V>
__device__ inline void atomic_add(const Check& c, int buf, T* p, V v) {
  if (global_ok(c, buf, p, sizeof(T), kStore)) atomicAdd(p, v);
}

// The acquire load of word i, or `fallback` where it faults.
__device__ inline unsigned long long ld_acquire(const Check& c, int buf,
                                                const unsigned long long* p, int64_t i,
                                                unsigned long long fallback) {
  return global_ok(c, buf, p + i, 8, kLoad) ? mcraw_ld_acquire(p + i) : fallback;
}

__device__ inline void st_release(const Check& c, int buf, unsigned long long* p, int64_t i,
                                  unsigned long long v) {
  if (global_ok(c, buf, p + i, 8, kStore)) mcraw_st_release(p + i, v);
}

// An atomic ticket: the word's old value, one added; `fallback` where it
// faults.
__device__ inline unsigned long long ticket(const Check& c, int buf, unsigned long long* p,
                                            unsigned long long fallback) {
  return global_ok(c, buf, p, 8, kStore) ? atomicAdd(p, 1ull) : fallback;
}

template <class T>
__device__ inline T sld(const Check& c, int id, const void* base, int64_t size, const T* p,
                        int64_t i) {
  return shared_ok(c, id, base, size, p + i, sizeof(T)) ? p[i] : T{};
}

template <class T, class V>
__device__ inline void sst(const Check& c, int id, const void* base, int64_t size, T* p,
                          int64_t i, V v) {
  if (shared_ok(c, id, base, size, p + i, sizeof(T))) p[i] = v;
}

// A 16-byte cp.async from global buffer `gbuf` into shared array `sid`.
__device__ inline bool cp_ok(const Check& c, int sid, const void* sbase, int64_t ssize,
                             const void* dst, int gbuf, const void* src) {
  const bool s = shared_ok(c, sid, sbase, ssize, dst, 16);
  const bool g = global_ok(c, gbuf, src, 16, kCpAsync);
  return s && g;
}

}  // namespace mcraw_check

// A kernel's extra parameter, its mutable copy (a batch frame sets its
// window there), a device function's parameter and argument.
#define MCRAW_CK_KERNEL_PARAM , const mcraw_check::Check ck_arg
#define MCRAW_CK_KERNEL_INIT mcraw_check::Check ck = ck_arg;
#define MCRAW_CK_PARAM , const mcraw_check::Check& ck
#define MCRAW_CK , ck
// An entry's extra parameter, forwarded to a helper, and the launch's
// argument.
#define MCRAW_CK_ENTRY_PARAM , mcraw_check::Args* check_args
#define MCRAW_CK_ENTRY , check_args
#define MCRAW_CK_LAUNCH(kernel, entry) , mcraw_check::make(check_args, kernel, entry)
// Frame f's window: `len` elements of `elem` bytes from element `base` of
// buffer `buf` (whose pointer `p` has not yet moved to the frame).
#define MCRAW_CK_WINDOW(buf, p, base, len, elem)                                     \
  ck.window_buf = buf;                                                               \
  ck.win_lo = reinterpret_cast<uint64_t>(p) + static_cast<uint64_t>(base) * (elem);  \
  ck.win_hi = ck.win_lo + static_cast<uint64_t>(len) * (elem) - ck.window_trim;
// Host-side accesses of an entry: return (no launch) on a fault, or (_IF)
// skip the statement that follows.
#define MCRAW_CK_HOST(kernel, entry, buf, kind, need)                                    \
  if (!mcraw_check::host_ok(check_args, kernel, entry, buf, mcraw_check::kind, need)) { \
    return 0;                                                                            \
  }
#define MCRAW_CK_HOST_IF(kernel, entry, buf, kind, need) \
  if (mcraw_check::host_ok(check_args, kernel, entry, buf, mcraw_check::kind, need))
#define MCRAW_LD(buf, p, i) mcraw_check::ld(ck, buf, p, i)
#define MCRAW_LDG(buf, p, i) mcraw_check::ldg(ck, buf, p, i)
#define MCRAW_ST(buf, p, i, v) mcraw_check::st(ck, buf, p, i, v)
#define MCRAW_ATOMIC_ADD(buf, p, v) mcraw_check::atomic_add(ck, buf, p, v)
#define MCRAW_ATOMIC_TICKET(buf, p, fallback) mcraw_check::ticket(ck, buf, p, fallback)
#define MCRAW_LD_ACQUIRE(buf, p, i, fallback) mcraw_check::ld_acquire(ck, buf, p, i, fallback)
#define MCRAW_ST_RELEASE(buf, p, i, v) mcraw_check::st_release(ck, buf, p, i, v)
// Shared memory: `arr` the array (its sizeof is the extent), or `base` and
// `size` where only a pointer to it is in scope.
#define MCRAW_SLD(id, arr, p, i) mcraw_check::sld(ck, id, arr, sizeof(arr), p, i)
#define MCRAW_SST(id, arr, p, i, v) mcraw_check::sst(ck, id, arr, sizeof(arr), p, i, v)
#define MCRAW_SLDN(id, base, size, p, i) mcraw_check::sld(ck, id, base, size, p, i)
#define MCRAW_SSTN(id, base, size, p, i, v) mcraw_check::sst(ck, id, base, size, p, i, v)
// [p, p + n) inside shared array `base` of `size`, for a copy that the
// hardware writes there (a TMA box): the checked build skips a copy that
// does not fit.
#define MCRAW_SHARED_OK(id, base, size, p, n) mcraw_check::shared_ok(ck, id, base, size, p, n)
#define MCRAW_CP_ASYNC16(sid, sarr, dst, gbuf, src) \
  if (mcraw_check::cp_ok(ck, sid, sarr, sizeof(sarr), dst, gbuf, src)) cp_async16(dst, src)

#else  // the default build: the plain accesses

#define MCRAW_CK_KERNEL_PARAM
#define MCRAW_CK_KERNEL_INIT
#define MCRAW_CK_PARAM
#define MCRAW_CK
#define MCRAW_CK_ENTRY_PARAM
#define MCRAW_CK_ENTRY
#define MCRAW_CK_LAUNCH(kernel, entry)
#define MCRAW_CK_WINDOW(buf, p, base, len, elem)
#define MCRAW_CK_HOST(kernel, entry, buf, kind, need)
#define MCRAW_CK_HOST_IF(kernel, entry, buf, kind, need)
#define MCRAW_LD(buf, p, i) ((p)[i])
#define MCRAW_LDG(buf, p, i) __ldg((p) + (i))
#define MCRAW_ST(buf, p, i, v) ((p)[i] = (v))
#define MCRAW_ATOMIC_ADD(buf, p, v) atomicAdd(p, v)
#define MCRAW_ATOMIC_TICKET(buf, p, fallback) atomicAdd(p, 1ull)
#define MCRAW_LD_ACQUIRE(buf, p, i, fallback) mcraw_ld_acquire((p) + (i))
#define MCRAW_ST_RELEASE(buf, p, i, v) mcraw_st_release((p) + (i), v)
#define MCRAW_SLD(id, arr, p, i) ((p)[i])
#define MCRAW_SST(id, arr, p, i, v) ((p)[i] = (v))
#define MCRAW_SLDN(id, base, size, p, i) ((p)[i])
#define MCRAW_SSTN(id, base, size, p, i, v) ((p)[i] = (v))
#define MCRAW_SHARED_OK(id, base, size, p, n) true
#define MCRAW_CP_ASYNC16(sid, sarr, dst, gbuf, src) cp_async16(dst, src)

#endif  // MCRAW_CHECKED
