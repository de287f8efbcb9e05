// rspt_torch_native — the host runtime of rspt_tpu_torch.
//
// The port's own copy of the parts of rspt_tpu/native/rspt_native.cpp
// that its main path calls, with the exported symbols renamed (rpt_*)
// so that both libraries can live in one process:
//   * CRC32C (Castagnoli): slice-by-8, and the SSE4.2 / ARMv8 crc32
//     instruction in three interleaved legs when the CPU has it;
//   * the per-block Huffman table builder (the reference's greedy tree
//     and tie order, preorder tree description);
//   * the block-parallel hzr decoder and hzr_verify;
//   * the nibble-level decode LUTs of the device decoder, recovered
//     straight from HUFF payload bits;
//   * the streaming path's serial f64 IIR filter, one channel or all of
//     them in threads, in both of the reference's accumulation orders;
//   * the LZ4 block codec of the LZ4 plane backend (greedy and HC
//     encoders, the bounds-checked decoder), a container's planes in
//     threads;
//   * the encode half of the all-host engine (packers/native.py): the
//     hzr block encoder, every 64 KiB block of every plane a work item,
//     the elementwise scans, swizzles and byte planes, the fused xdelta
//     preprocess (with the port's plane-growth rule) and its inverse,
//     the exact serial-f64 DCT, the FWHT, and the fused streaming span
//     (filter, xdelta, verify-and-grow and encode of every frame in one
//     call).
// Tree build, tree recovery and the bit reader are copied unchanged:
// their order is what keeps every stream byte-identical; the IIR's and
// the DCT's operation order (and -ffp-contract=off) keep their f64 bits
// equal. Every f64 -> int32 conversion is written out as x86's
// cvttsd2si (INT32_MIN outside the range, NaN included), which is what
// the reference's (int32_t) casts give on its machines.
//
// Built by rspt_tpu_torch/native/_build.py with g++ at first use.

#include <cstdint>
#include <cstddef>
#include <cstring>
#include <climits>
#include <condition_variable>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>
#include <atomic>

namespace {

// ---------------------------------------------------------------------------
// Persistent thread pool (the nibble-LUT batch runs on it). Workers
// park on a condition variable; the caller participates in every run.
// ---------------------------------------------------------------------------

class ThreadPool {
  public:
    explicit ThreadPool(int nworkers) {
        for (int i = 0; i < nworkers; ++i)
            workers_.emplace_back([this] { loop(); });
    }

    // Execute fn(slot) for slot in [0, m); returns when all done.
    // Callers from several threads take turns: one run's fn_, total_
    // and counters at a time.
    void run(int m, const std::function<void(int)>& fn) {
        if (m <= 1) {
            for (int s = 0; s < m; ++s) fn(s);
            return;
        }
        std::lock_guard<std::mutex> turn(run_mu_);
        std::unique_lock<std::mutex> lk(mu_);
        fn_ = &fn;
        total_.store(m, std::memory_order_release);
        done_.store(0, std::memory_order_relaxed);
        // release: publishes fn_/total_/done_ to workers that skip the
        // cv path (late wakers from a previous epoch)
        next_.store(0, std::memory_order_release);
        ++epoch_;
        cv_.notify_all();
        lk.unlock();
        work();  // caller participates
        lk.lock();
        cv_done_.wait(lk, [&] {
            return done_.load(std::memory_order_acquire)
                >= total_.load(std::memory_order_relaxed);
        });
        // close the gate: a late waker from this epoch must never see
        // next_ below a LATER run's total_ (it would claim a slot
        // before that run resets next_). Huge next_ + zero total_
        // makes the work() guard fail for any stale state.
        next_.store(1 << 30, std::memory_order_relaxed);
        total_.store(0, std::memory_order_relaxed);
        fn_ = nullptr;
    }

    static ThreadPool& inst() {
        // leaked on purpose: joining at static destruction deadlocks
        static ThreadPool* p = new ThreadPool(
            (int)std::thread::hardware_concurrency() - 1);
        return *p;
    }

  private:
    void work() {
        int s;
        // total_ is atomic (published with release in run()); fn_ is
        // loaded into a local AFTER the next_ acquire so the pointer
        // read is ordered behind the epoch's publication — no UB race
        while ((s = next_.fetch_add(1, std::memory_order_acquire))
               < total_.load(std::memory_order_acquire)) {
            const std::function<void(int)>* fn = fn_;
            (*fn)(s);
            if (done_.fetch_add(1, std::memory_order_acq_rel) + 1
                >= total_.load(std::memory_order_relaxed)) {
                std::lock_guard<std::mutex> lk(mu_);
                cv_done_.notify_all();
            }
        }
    }

    void loop() {
        uint64_t seen = 0;
        for (;;) {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [&] { return epoch_ != seen; });
            seen = epoch_;
            lk.unlock();
            work();
        }
    }

    std::mutex run_mu_;
    std::mutex mu_;
    std::condition_variable cv_, cv_done_;
    std::vector<std::thread> workers_;
    const std::function<void(int)>* fn_ = nullptr;
    std::atomic<int> total_{0};
    uint64_t epoch_ = 0;
    std::atomic<int> next_{0};
    std::atomic<int> done_{0};
};

// Split [0, n) into nt ranges and run them on the pool.
inline void pool_ranges(size_t n, size_t nt,
                        const std::function<void(size_t, size_t)>& fn) {
    if (nt > n) nt = n;
    if (nt <= 1) {
        fn(0, n);
        return;
    }
    std::function<void(int)> slot = [&](int t) {
        fn(n * (size_t)t / nt, n * ((size_t)t + 1) / nt);
    };
    ThreadPool::inst().run((int)nt, slot);
}

// fn(i) for every i in [0, m) on at most nt pool slots (nt <= 0: one a
// hardware thread), the items handed out in order by a shared counter:
// items of unequal cost (a COPY block beside a Huffman one) balance.
inline void pool_items(size_t m, int nt, const std::function<void(size_t)>& fn) {
    if (nt <= 0) nt = (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if ((size_t)nt > m) nt = (int)m;
    if (nt <= 1) {
        for (size_t i = 0; i < m; ++i) fn(i);
        return;
    }
    std::atomic<size_t> next(0);
    std::function<void(int)> slot = [&](int) {
        size_t i;
        while ((i = next.fetch_add(1)) < m) fn(i);
    };
    ThreadPool::inst().run(nt, slot);
}

inline int resolve_threads(int nthreads) {
    if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
    return nthreads < 1 ? 1 : nthreads;
}

// ---------------------------------------------------------------------------
// CRC32C, slice-by-8
// ---------------------------------------------------------------------------

uint32_t g_crc_tab[8][256];

struct CrcInit {
    CrcInit() {
        const uint32_t poly = 0x82F63B78u;
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? poly : 0);
            g_crc_tab[0][i] = c;
        }
        for (int j = 1; j < 8; ++j)
            for (uint32_t i = 0; i < 256; ++i)
                g_crc_tab[j][i] = g_crc_tab[0][g_crc_tab[j - 1][i] & 0xFF] ^
                                  (g_crc_tab[j - 1][i] >> 8);
    }
} g_crc_init;

static uint32_t crc32c_sw(const uint8_t* p, size_t n, uint32_t c) {
    while (n >= 8) {
        uint32_t lo, hi;
        memcpy(&lo, p, 4);
        memcpy(&hi, p + 4, 4);
        lo ^= c;
        c = g_crc_tab[7][lo & 0xFF] ^ g_crc_tab[6][(lo >> 8) & 0xFF] ^
            g_crc_tab[5][(lo >> 16) & 0xFF] ^ g_crc_tab[4][lo >> 24] ^
            g_crc_tab[3][hi & 0xFF] ^ g_crc_tab[2][(hi >> 8) & 0xFF] ^
            g_crc_tab[1][(hi >> 16) & 0xFF] ^ g_crc_tab[0][hi >> 24];
        p += 8;
        n -= 8;
    }
    while (n--) c = g_crc_tab[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
    return c;
}

// Hardware CRC32C with runtime dispatch (the reference runtime-
// dispatches SSE4.2/ARMv8 single-stream loops, hzr_crc32c_sse4.c:30-80;
// here the HW path additionally runs 3 interleaved streams to cover
// the crc32 instruction's 3-cycle latency, recombined with
// precomputed GF(2) shift-by-leg tables).
static const size_t kCrcLeg = 2048;  // bytes per interleaved stream leg

uint32_t g_crc_shift[4][256];  // c -> state after kCrcLeg zero bytes

struct CrcShiftInit {
    CrcShiftInit() {  // runs after g_crc_init (same TU, declared later)
        uint32_t z[32];
        for (int i = 0; i < 32; ++i) {
            uint32_t c = 1u << i;
            for (size_t k = 0; k < kCrcLeg; ++k)
                c = g_crc_tab[0][c & 0xFF] ^ (c >> 8);
            z[i] = c;  // zero-byte evolution is GF(2)-linear in state
        }
        for (int j = 0; j < 4; ++j)
            for (uint32_t b = 0; b < 256; ++b) {
                uint32_t r = 0;
                for (int k = 0; k < 8; ++k)
                    if (b & (1u << k)) r ^= z[8 * j + k];
                g_crc_shift[j][b] = r;
            }
    }
} g_crc_shift_init;

static inline uint32_t crc_shift_leg(uint32_t c) {
    return g_crc_shift[0][c & 0xFF] ^ g_crc_shift[1][(c >> 8) & 0xFF] ^
           g_crc_shift[2][(c >> 16) & 0xFF] ^ g_crc_shift[3][c >> 24];
}

#if defined(__x86_64__) || defined(__i386__)
#include <nmmintrin.h>

__attribute__((target("sse4.2")))
static uint32_t crc32c_hw(const uint8_t* p, size_t n, uint32_t c) {
    while (n >= 3 * kCrcLeg) {
        uint64_t a = c, b = 0, d = 0;
        const uint8_t* p1 = p + kCrcLeg;
        const uint8_t* p2 = p + 2 * kCrcLeg;
        for (size_t i = 0; i < kCrcLeg; i += 8) {
            uint64_t w0, w1, w2;
            memcpy(&w0, p + i, 8);
            memcpy(&w1, p1 + i, 8);
            memcpy(&w2, p2 + i, 8);
            a = _mm_crc32_u64(a, w0);
            b = _mm_crc32_u64(b, w1);
            d = _mm_crc32_u64(d, w2);
        }
        // crc(X||Y) state = shift(state_X) ^ state_Y_from_zero
        c = crc_shift_leg(crc_shift_leg((uint32_t)a) ^ (uint32_t)b) ^
            (uint32_t)d;
        p += 3 * kCrcLeg;
        n -= 3 * kCrcLeg;
    }
    while (n >= 8) {
        uint64_t w;
        memcpy(&w, p, 8);
        c = (uint32_t)_mm_crc32_u64(c, w);
        p += 8;
        n -= 8;
    }
    while (n--) c = _mm_crc32_u8(c, *p++);
    return c;
}

static bool crc_hw_ok() {
    static const bool v = __builtin_cpu_supports("sse4.2");
    return v;
}
#elif defined(__aarch64__)
#include <arm_acle.h>
#include <asm/hwcap.h>
#include <sys/auxv.h>

__attribute__((target("+crc")))
static uint32_t crc32c_hw(const uint8_t* p, size_t n, uint32_t c) {
    while (n >= 3 * kCrcLeg) {
        uint32_t a = c, b = 0, d = 0;
        const uint8_t* p1 = p + kCrcLeg;
        const uint8_t* p2 = p + 2 * kCrcLeg;
        for (size_t i = 0; i < kCrcLeg; i += 8) {
            uint64_t w0, w1, w2;
            memcpy(&w0, p + i, 8);
            memcpy(&w1, p1 + i, 8);
            memcpy(&w2, p2 + i, 8);
            a = __crc32cd(a, w0);
            b = __crc32cd(b, w1);
            d = __crc32cd(d, w2);
        }
        c = crc_shift_leg(crc_shift_leg(a) ^ b) ^ d;
        p += 3 * kCrcLeg;
        n -= 3 * kCrcLeg;
    }
    while (n >= 8) {
        uint64_t w;
        memcpy(&w, p, 8);
        c = __crc32cd(c, w);
        p += 8;
        n -= 8;
    }
    while (n--) c = __crc32cb(c, *p++);
    return c;
}

static bool crc_hw_ok() {
#if defined(__ARM_FEATURE_CRC32)
    return true;
#else
    return (getauxval(AT_HWCAP) & HWCAP_CRC32) != 0;
#endif
}
#else
static uint32_t crc32c_hw(const uint8_t* p, size_t n, uint32_t c) {
    return crc32c_sw(p, n, c);
}
static bool crc_hw_ok() { return false; }
#endif

// crc: the CRC32C of the bytes before p (0 for none), so that
// crc32c(b, m, crc32c(a, k)) == crc32c(a || b, k + m).
uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc = 0) {
    uint32_t c = ~crc;
    c = crc_hw_ok() ? crc32c_hw(p, n, c) : crc32c_sw(p, n, c);
    return ~c;
}

// ---------------------------------------------------------------------------
// hzr format constants (see rspt_tpu/formats/hzr_constants.py)
// ---------------------------------------------------------------------------

constexpr size_t kHeaderSize = 4;
constexpr size_t kBlockHeaderSize = 7;
constexpr size_t kMaxBlockSize = 65536;
constexpr int kModeCopy = 0;
constexpr int kModeHuffRle = 1;
constexpr int kModeFill = 2;
constexpr int kNumSyms = 261;
constexpr int kMaxNodes = kNumSyms * 2 - 1;  // 521
constexpr int kSymBits = 9;
constexpr uint32_t kMaxZeroRun = 16662;

// RLE classification: run length -> (symbol, extra value, extra bits)
inline void classify_run(uint32_t len, uint16_t& sym, uint16_t& extra,
                         uint8_t& ebits) {
    if (len == 1)       { sym = 0;   extra = 0;          ebits = 0; }
    else if (len == 2)  { sym = 256; extra = 0;          ebits = 0; }
    else if (len <= 6)  { sym = 257; extra = len - 3;    ebits = 2; }
    else if (len <= 22) { sym = 258; extra = len - 7;    ebits = 4; }
    else if (len <= 278){ sym = 259; extra = len - 23;   ebits = 8; }
    else                { sym = 260; extra = len - 279;  ebits = 14; }
}

// x86's (int32_t) of a double (cvttsd2si): truncation inside the int32
// range, INT32_MIN outside it, positive overflow and NaN included. A C++
// cast of an out-of-range double is undefined, so it is never relied on.
inline int32_t x86_i32(double v) {
    return (v > -2147483649.0 && v < 2147483648.0) ? (int32_t)v : INT32_MIN;
}

// The low `bits` bits of v, sign-extended (bits 8..32).
inline int32_t sext(uint32_t v, int bits) {
    int sh = 32 - bits;
    return (int32_t)(v << sh) >> sh;
}

// The xdelta packer's plane-growth rule (ops/cuda_kernels._fits_planes):
// npl planes keep a bps-byte sample iff sign-extending the value's low
// 8 * npl bits leaves its low 8 * bps bits unchanged (the reference's
// compress -> decompress -> compare of the native samples); always at
// npl >= bps.
inline bool planes_keep(uint32_t x, int npl, int bps) {
    if (npl >= bps) return true;
    uint32_t keep = bps >= 4 ? 0xFFFFFFFFu : ((1u << (8 * bps)) - 1);
    return (((uint32_t)sext(x, 8 * npl) ^ x) & keep) == 0;
}


// ---------------------------------------------------------------------------
// LSB-first bit writer with 64-bit cache
// ---------------------------------------------------------------------------

struct BitWriter {
    uint8_t* base;
    uint8_t* p;
    uint8_t* end;
    uint64_t cache = 0;
    int nbits = 0;
    bool failed = false;

    BitWriter(uint8_t* buf, size_t cap) : base(buf), p(buf), end(buf + cap) {}

    inline void put(uint32_t value, int bits) {  // bits <= 32, high bits of value zero
        cache |= (uint64_t)value << nbits;
        nbits += bits;
        while (nbits >= 8) {
            if (p >= end) { failed = true; nbits = 0; return; }
            *p++ = (uint8_t)cache;
            cache >>= 8;
            nbits -= 8;
        }
    }
    inline void put64(uint64_t value, int bits) {  // bits <= 56
        cache |= value << nbits;
        nbits += bits;
        if (nbits >= 8) {
            int nb = nbits >> 3;
            if (p + 8 <= end) {  // bulk spill: one unaligned store
                memcpy(p, &cache, 8);
                p += nb;
                cache >>= nb * 8;
                nbits &= 7;
            } else {
                while (nbits >= 8) {
                    if (p >= end) { failed = true; nbits = 0; return; }
                    *p++ = (uint8_t)cache;
                    cache >>= 8;
                    nbits -= 8;
                }
            }
        }
    }
    inline void flush_partial() {
        if (nbits > 0) {
            if (p >= end) { failed = true; return; }
            *p++ = (uint8_t)(cache & (0xFF >> (8 - nbits)));
            cache = 0;
            nbits = 0;
        }
    }
    size_t bytes_written() const { return (size_t)(p - base); }
    size_t bit_count() const { return 8 * (size_t)(p - base) + nbits; }
};

// LSB-first bit reader
struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t cache = 0;
    int nbits = 0;
    bool failed = false;

    BitReader(const uint8_t* buf, size_t n) : p(buf), end(buf + n) {}

    inline void fill() {
        while (nbits <= 56 && p < end) {
            cache |= (uint64_t)(*p++) << nbits;
            nbits += 8;
        }
    }
    inline uint32_t get(int bits) {
        if (nbits < bits) {
            fill();
            if (nbits < bits) { failed = true; return 0; }
        }
        uint32_t v = (uint32_t)(cache & ((bits == 32) ? 0xFFFFFFFFu
                                                      : ((1u << bits) - 1)));
        cache >>= bits;
        nbits -= bits;
        return v;
    }
    inline int get1() {
        if (nbits < 1) {
            fill();
            if (nbits < 1) { failed = true; return 0; }
        }
        int v = (int)(cache & 1);
        cache >>= 1;
        nbits -= 1;
        return v;
    }
    // Bytes consumed, rounding the current partial byte up.
    size_t consumed(const uint8_t* start) const {
        return (size_t)(p - start) - (size_t)(nbits >> 3);
    }
};

// ---------------------------------------------------------------------------
// Huffman tree, replicating the reference's greedy build + tie-breaking
// (hzr_encode.c:222-283): scan nodes[0..next) each round, `<=` means the
// latest minimal node wins; internal nodes append after leaves.
//
// The scan's selection is equivalent to popping the two minima of the
// strict total order (count asc, node index DESC): the `<=` replacement
// makes the LAST minimal index win for n1, and the same tie rule holds
// for n2 (invariant count[n1] <= count[n2] after every step). A binary
// min-heap keyed on (count << 16) | (0xFFFF - index) therefore
// reproduces the reference's merge sequence bit-exactly in O(n log n)
// instead of the O(n^2) rescan — the rescan cost ~1.2 ns per input
// byte on 48-64 KiB blocks, half the whole encode stage.
// ---------------------------------------------------------------------------

struct TreeCtx {
    int16_t sym[kMaxNodes];     // >=0 leaf symbol, -1 branch
    int16_t child_a[kMaxNodes];
    int16_t child_b[kMaxNodes];
    uint32_t count[kMaxNodes];
    int next = 0;
    int root = -1;
    bool single = false;
};

void build_tree(const uint32_t* hist, TreeCtx& t) {
    t.next = 0;
    for (int s = 0; s < kNumSyms; ++s) {
        if (hist[s] > 0) {
            t.sym[t.next] = (int16_t)s;
            t.count[t.next] = hist[s];
            t.child_a[t.next] = t.child_b[t.next] = -1;
            ++t.next;
        }
    }
    int num_symbols = t.next;
    t.root = -1;
    t.single = false;
    if (num_symbols == 0) return;
    if (num_symbols == 1) {
        t.root = 0;
        t.single = true;
        return;
    }
    // min-heap over (count << 16) | (0xFFFF - index); counts are block
    // token totals (<= 64Ki) so they fit 17 bits and never collide with
    // the index field after summing (<= 2^17 << 16 < 2^64).
    uint64_t heap[kMaxNodes];
    int hn = 0;
    auto hpush = [&](uint64_t key) {
        int i = hn++;
        heap[i] = key;
        while (i > 0) {
            int p = (i - 1) >> 1;
            if (heap[p] <= heap[i]) break;
            std::swap(heap[p], heap[i]);
            i = p;
        }
    };
    auto hpop = [&]() -> uint64_t {
        uint64_t top = heap[0];
        heap[0] = heap[--hn];
        int i = 0;
        for (;;) {
            int l = 2 * i + 1, r2 = l + 1, m = i;
            if (l < hn && heap[l] < heap[m]) m = l;
            if (r2 < hn && heap[r2] < heap[m]) m = r2;
            if (m == i) break;
            std::swap(heap[i], heap[m]);
            i = m;
        }
        return top;
    };
    for (int k = 0; k < num_symbols; ++k)
        hpush(((uint64_t)t.count[k] << 16) | (uint64_t)(0xFFFF - k));
    while (hn > 1) {
        uint64_t k1 = hpop(), k2 = hpop();
        int n1 = 0xFFFF - (int)(k1 & 0xFFFF);
        int n2 = 0xFFFF - (int)(k2 & 0xFFFF);
        int r = t.next++;
        t.sym[r] = -1;
        t.child_a[r] = (int16_t)n1;
        t.child_b[r] = (int16_t)n2;
        t.count[r] = t.count[n1] + t.count[n2];
        t.count[n1] = 0;
        t.count[n2] = 0;
        t.root = r;
        hpush(((uint64_t)t.count[r] << 16) | (uint64_t)(0xFFFF - r));
    }
}

// Preorder serialization: leaf = 1 + 9-bit symbol; branch = 0 then A (code
// unchanged) and B (bit `bits` set). Explicit stack; pushing B before A
// reproduces the recursive A-then-B order (hzr_encode.c:177-219).
void store_tree(const TreeCtx& t, BitWriter& bw, uint32_t* codes,
                uint8_t* code_bits) {
    struct Item { int16_t node; uint32_t code; uint8_t bits; };
    Item stack[kMaxNodes + 1];
    int sp = 0;
    stack[sp++] = {(int16_t)t.root, 0u, (uint8_t)(t.single ? 1 : 0)};
    while (sp > 0) {
        Item it = stack[--sp];
        if (t.sym[it.node] >= 0) {
            bw.put(1, 1);
            bw.put((uint32_t)t.sym[it.node], kSymBits);
            codes[t.sym[it.node]] = it.code;
            code_bits[t.sym[it.node]] = it.bits;
            if (bw.failed) return;
            continue;
        }
        bw.put(0, 1);
        if (bw.failed) return;
        stack[sp++] = {t.child_b[it.node],
                       it.code | (1u << it.bits), (uint8_t)(it.bits + 1)};
        stack[sp++] = {t.child_a[it.node], it.code, (uint8_t)(it.bits + 1)};
    }
}

// true if all tokens are in one code class; zeros (sym 0 / RLE) are one
// class (hzr_encode.c:285-305)
bool only_single_code(const uint32_t* hist) {
    int has_zeros = (hist[0] > 0) ? 1 : 0;
    for (int s = 256; s < kNumSyms; ++s)
        if (hist[s] > 0) { has_zeros = 1; break; }
    int nonzero = 0;
    for (int s = 1; s < 256; ++s)
        if (hist[s] > 0 && ++nonzero + has_zeros > 1) return false;
    return (nonzero + has_zeros) == 1;
}

// ---------------------------------------------------------------------------
// Block encode (rspt_native.cpp:436-748): a histogram pass over the raw
// bytes, then the runs re-derived and the codes emitted directly.
// ---------------------------------------------------------------------------

// Length of the zero run at in[k] (capped, never crossing the block
// edge), with 8-byte word skipping for long runs.
static inline size_t zero_run_len(const uint8_t* in, size_t n, size_t k) {
    size_t lim = n - k;
    if (lim > kMaxZeroRun) lim = kMaxZeroRun;
    size_t z = 1;
    while (z + 8 <= lim) {
        uint64_t w;
        memcpy(&w, in + k + z, 8);
        if (w != 0) return z + (size_t)(__builtin_ctzll(w) >> 3);
        z += 8;
    }
    while (z < lim && in[k + z] == 0) ++z;
    return z;
}

// The block's 261-symbol histogram without materializing tokens (4-way
// split literal counters dodge store-forward stalls on repeated bytes).
static void histogram_runs(const uint8_t* in, size_t n, uint32_t* hist) {
    uint32_t h[4][256];
    memset(h, 0, sizeof(h));
    memset(hist, 0, kNumSyms * sizeof(uint32_t));
    size_t k = 0;
    while (k < n) {
        while (k + 4 <= n) {
            uint8_t b0 = in[k], b1 = in[k + 1], b2 = in[k + 2],
                    b3 = in[k + 3];
            if (!(b0 && b1 && b2 && b3)) break;
            h[0][b0]++;
            h[1][b1]++;
            h[2][b2]++;
            h[3][b3]++;
            k += 4;
        }
        if (k >= n) break;
        uint8_t b = in[k];
        if (b != 0) {
            h[0][b]++;
            ++k;
            continue;
        }
        size_t z = zero_run_len(in, n, k);
        uint16_t sym, extra;
        uint8_t ebits;
        classify_run((uint32_t)z, sym, extra, ebits);
        hist[sym]++;
        k += z;
    }
    for (int s = 1; s < 256; ++s)
        hist[s] += h[0][s] + h[1][s] + h[2][s] + h[3][s];
}

inline void write_block_header(uint8_t* hdr, uint16_t size_minus_1,
                               uint32_t crc, uint8_t mode) {
    hdr[0] = (uint8_t)size_minus_1;
    hdr[1] = (uint8_t)(size_minus_1 >> 8);
    memcpy(hdr + 2, &crc, 4);
    hdr[6] = mode;
}

// One block (1 <= in_size <= 64 KiB) with its histogram: FILL for one
// code class, else HUFF unless its payload reaches in_size or 64 KiB
// (then COPY). Returns the encoded size with the header, or 0 if cap is
// too small.
size_t encode_block_hist(const uint8_t* in, size_t in_size,
                         const uint32_t* hist, uint8_t* out, size_t cap) {
    if (only_single_code(hist)) {  // FILL
        if (cap < kBlockHeaderSize + 1) return 0;
        write_block_header(out, 0, crc32c(in, 1), kModeFill);
        out[kBlockHeaderSize] = in[0];
        return kBlockHeaderSize + 1;
    }
    size_t payload_cap = in_size;
    if (cap < kBlockHeaderSize) return 0;
    if (cap - kBlockHeaderSize < payload_cap)
        payload_cap = cap - kBlockHeaderSize;

    TreeCtx tree;
    build_tree(hist, tree);
    uint32_t codes[kNumSyms];
    uint8_t code_bits[kNumSyms];
    BitWriter bw(out + kBlockHeaderSize, payload_cap);
    store_tree(tree, bw, codes, code_bits);

    if (!bw.failed) {
        size_t k = 0;
        while (k < in_size && !bw.failed) {
            // four (or two) adjacent literal codes merged into one put64:
            // the same bits, LSB-first fields side by side
            while (k + 4 <= in_size) {
                uint8_t b0 = in[k], b1 = in[k + 1], b2 = in[k + 2],
                        b3 = in[k + 3];
                if (!(b0 && b1 && b2 && b3)) break;
                int n01 = code_bits[b0] + code_bits[b1];
                int n23 = code_bits[b2] + code_bits[b3];
                uint64_t v01 = (uint64_t)codes[b0] |
                               ((uint64_t)codes[b1] << code_bits[b0]);
                uint64_t v23 = (uint64_t)codes[b2] |
                               ((uint64_t)codes[b3] << code_bits[b2]);
                if (n01 + n23 <= 56) {
                    bw.put64(v01 | (v23 << n01), n01 + n23);
                } else {
                    bw.put64(v01, n01);
                    bw.put64(v23, n23);
                }
                if (bw.failed) break;
                k += 4;
            }
            while (k + 2 <= in_size && !bw.failed) {
                uint8_t b0 = in[k], b1 = in[k + 1];
                if (!(b0 && b1)) break;
                bw.put64((uint64_t)codes[b0] |
                             ((uint64_t)codes[b1] << code_bits[b0]),
                         code_bits[b0] + code_bits[b1]);
                k += 2;
            }
            if (k >= in_size || bw.failed) break;
            uint8_t b = in[k];
            if (b != 0) {
                bw.put64(codes[b], code_bits[b]);
                ++k;
                continue;
            }
            size_t z = zero_run_len(in, in_size, k);
            uint16_t sym, extra;
            uint8_t ebits;
            classify_run((uint32_t)z, sym, extra, ebits);
            bw.put64((uint64_t)codes[sym] |
                         ((uint64_t)extra << code_bits[sym]),
                     code_bits[sym] + ebits);
            k += z;
        }
    }
    if (!bw.failed) bw.flush_partial();

    size_t payload = bw.bytes_written();
    if (bw.failed || payload >= kMaxBlockSize) {  // COPY fallback
        if (cap < kBlockHeaderSize + in_size) return 0;
        write_block_header(out, (uint16_t)(in_size - 1), crc32c(in, in_size),
                           kModeCopy);
        memcpy(out + kBlockHeaderSize, in, in_size);
        return kBlockHeaderSize + in_size;
    }
    write_block_header(out, (uint16_t)(payload - 1),
                       crc32c(out + kBlockHeaderSize, payload), kModeHuffRle);
    return kBlockHeaderSize + payload;
}

size_t encode_block(const uint8_t* in, size_t in_size, uint8_t* out,
                    size_t cap) {
    uint32_t hist[kNumSyms];
    histogram_runs(in, in_size, hist);
    return encode_block_hist(in, in_size, hist, out, cap);
}

// Worst case of a stream of n bytes: its header, and each block COPY.
size_t hzr_max_size(size_t n) {
    size_t blocks = (n + kMaxBlockSize - 1) / kMaxBlockSize;
    return kHeaderSize + blocks * kBlockHeaderSize + n;
}

// ---------------------------------------------------------------------------
// Block decode
// ---------------------------------------------------------------------------

constexpr int kLutBits = 13;
constexpr int kLutSize = 1 << kLutBits;

struct DecTree {
    int16_t child_a[kMaxNodes];
    int16_t child_b[kMaxNodes];
    int16_t sym[kMaxNodes];
    int count = 0;
    // kLutBits-wide peek LUT: node >= 0 means continue walking from
    // node; else terminal with symbol/consumed-bits.
    int16_t lut_node[kLutSize];
    uint16_t lut_sym[kLutSize];
    uint8_t lut_bits[kLutSize];
};

// Iterative preorder tree recovery mirroring RecoverTree
// (hzr_decode.c:263-333) including the node-count limit.
int recover_tree(BitReader& br, DecTree& t) {
    struct Item { int16_t parent; uint32_t code; uint8_t bits; bool is_b; };
    Item stack[kMaxNodes + 1];
    int sp = 0;
    t.count = 0;
    // seed: the root
    stack[sp++] = {-1, 0u, 0, false};
    int root = -1;
    while (sp > 0) {
        Item it = stack[--sp];
        int idx = t.count++;
        if (t.count >= kMaxNodes) return -1;
        if (it.parent >= 0) {
            if (it.is_b) t.child_b[it.parent] = (int16_t)idx;
            else t.child_a[it.parent] = (int16_t)idx;
        } else {
            root = idx;
        }
        t.sym[idx] = -1;
        t.child_a[idx] = t.child_b[idx] = -1;
        int is_leaf = br.get1();
        if (br.failed) return -1;
        if (is_leaf) {
            int sym = (int)br.get(kSymBits);
            if (br.failed) return -1;
            t.sym[idx] = (int16_t)sym;
            if (it.bits <= kLutBits) {
                uint32_t dups = (uint32_t)kLutSize >> it.bits;
                uint8_t b = it.bits > 1 ? it.bits : 1;  // single-symbol case
                for (uint32_t i = 0; i < dups; ++i) {
                    uint32_t slot = (i << it.bits) | it.code;
                    t.lut_node[slot] = -1;
                    t.lut_sym[slot] = (uint16_t)sym;
                    t.lut_bits[slot] = b;
                }
            }
            continue;
        }
        if (it.bits == kLutBits) {
            t.lut_node[it.code] = (int16_t)idx;
            t.lut_sym[it.code] = 0;
            t.lut_bits[it.code] = kLutBits;
        }
        // push B then A so A is processed first (preorder)
        stack[sp++] = {(int16_t)idx, it.code | (1u << it.bits),
                       (uint8_t)(it.bits + 1), true};
        stack[sp++] = {(int16_t)idx, it.code, (uint8_t)(it.bits + 1), false};
    }
    return root;
}

// Decode one block's payload into out[0..out_size). Returns 0 on success.
int decode_block_payload(const uint8_t* payload, size_t payload_len,
                         uint8_t* out, size_t out_size) {
    BitReader br(payload, payload_len);
    DecTree tree;
    int root = recover_tree(br, tree);
    if (root < 0) return 1;
    bool single = tree.sym[root] >= 0;

    uint8_t* op = out;
    uint8_t* oend = out + out_size;
    while (op < oend) {
        int sym;
        if (single) {
            br.get1();
            if (br.failed) return 1;
            sym = tree.sym[root];
        } else {
            // branchless 8-byte refill while far from the input end
            if (br.nbits < 56 && br.p + 8 <= br.end) {
                uint64_t w;
                memcpy(&w, br.p, 8);
                br.cache |= w << br.nbits;
                br.p += (63 - br.nbits) >> 3;
                br.nbits |= 56;
            } else {
                br.fill();
            }
            if (br.nbits >= kLutBits) {
                uint32_t peek = (uint32_t)(br.cache & (kLutSize - 1));
                int16_t node = tree.lut_node[peek];
                uint8_t bits = tree.lut_bits[peek];
                br.cache >>= bits;
                br.nbits -= bits;
                if (node < 0) {
                    sym = tree.lut_sym[peek];
                } else {
                    while (tree.sym[node] < 0) {
                        int b = br.get1();
                        if (br.failed) return 1;
                        node = b ? tree.child_b[node] : tree.child_a[node];
                    }
                    sym = tree.sym[node];
                }
            } else {
                // tail: plain tree walk
                int16_t node = (int16_t)root;
                while (tree.sym[node] < 0) {
                    int b = br.get1();
                    if (br.failed) return 1;
                    node = b ? tree.child_b[node] : tree.child_a[node];
                }
                sym = tree.sym[node];
            }
        }
        if (sym <= 255) {
            *op++ = (uint8_t)sym;
        } else {
            size_t zeros;
            switch (sym) {
                case 256: zeros = 2; break;
                case 257: zeros = (size_t)br.get(2) + 3; break;
                case 258: zeros = (size_t)br.get(4) + 7; break;
                case 259: zeros = (size_t)br.get(8) + 23; break;
                case 260: zeros = (size_t)br.get(14) + 279; break;
                default: return 1;
            }
            if (br.failed || op + zeros > oend) return 1;
            memset(op, 0, zeros);
            op += zeros;
        }
    }
    return 0;
}

// Nibble-format decode LUTs (hzr/gpu_decoder.build_lut_nib): 8-bit
// root l1 (256 i32): leaf -> sym | bits<<16 (bits<=8; degenerate
// single leaf consumes 1); deep -> (1<<30) | slot. Level-k slot = 16
// i32: leaf -> sym | (8+4k+b)<<16; internal at the nibble boundary ->
// (1<<30) | next-level slot. Returns 0, or -1 on parse error /
// >24-bit code / slot-cap overflow (the caller routes such blocks to
// the host decoder — consistent with the cost heuristic, which
// rejects them anyway at any sane chunk cap).
static int declutnib_one(const uint8_t* payload, size_t plen,
                         int32_t* l1, int32_t* lvls, int32_t* nslots,
                         int cap_slots, int32_t* dbits_out) {
    BitReader br(payload, plen);
    DecTree t;
    int root = recover_tree(br, t);
    if (root < 0) return -1;
    *dbits_out =
        (int32_t)(8 * (size_t)(br.p - payload) - (size_t)br.nbits);
    for (int k = 0; k < 4; ++k) nslots[k] = 0;
    std::function<int(int16_t, int)> walk_nib = [&](int16_t node,
                                                    int lvl) -> int {
        if (lvl >= 4) return -1;
        if (nslots[lvl] >= cap_slots) return -1;
        int sid = nslots[lvl]++;
        int32_t* arr = lvls + ((size_t)lvl * cap_slots + sid) * 16;
        std::function<bool(int16_t, uint32_t, int)> w =
            [&](int16_t nd, uint32_t c, int b) -> bool {
            if (t.sym[nd] >= 0) {
                uint32_t step = 1u << b;
                int32_t v = (int32_t)t.sym[nd]
                            | ((8 + 4 * lvl + b) << 16);
                for (uint32_t i = c; i < 16u; i += step) arr[i] = v;
                return true;
            }
            if (b == 4) {
                int s2 = walk_nib(nd, lvl + 1);
                if (s2 < 0) return false;
                arr[c] = (int32_t)((1u << 30) | (uint32_t)s2);
                return true;
            }
            return w(t.child_a[nd], c, b + 1) &&
                   w(t.child_b[nd], c | (1u << b), b + 1);
        };
        return w(node, 0, 0) ? sid : -1;
    };
    std::function<bool(int16_t, uint32_t, int)> walk =
        [&](int16_t nd, uint32_t code, int bits) -> bool {
        if (t.sym[nd] >= 0) {
            int b = bits > 0 ? bits : 1;
            uint32_t step = 1u << bits;
            int32_t v = (int32_t)t.sym[nd] | (b << 16);
            for (uint32_t c = code; c < 256u; c += step) l1[c] = v;
            return true;
        }
        if (bits == 8) {
            int sid = walk_nib(nd, 0);
            if (sid < 0) return false;
            l1[code] = (int32_t)((1u << 30) | (uint32_t)sid);
            return true;
        }
        return walk(t.child_a[nd], code, bits + 1) &&
               walk(t.child_b[nd], code | (1u << bits), bits + 1);
    };
    return walk((int16_t)root, 0, 0) ? 0 : -1;
}

// ---------------------------------------------------------------------------
// IIR filter (rspt_native.cpp:1874-1955, iir_filter.cpp:26-107): a
// direct-form-I recurrence with p coefficients, state rings xz / yz of
// length p (index 0 the newest), updated in place. opt = 1 is filter_opt's
// order (every feedforward term left to right, then every feedback
// subtraction), opt = 0 the generic filter's (the two interleaved a
// tap). Fixed orders 2..5 keep the state in registers; the operation
// order is the generic loop's, so the bits are the same.
// ---------------------------------------------------------------------------

#define RPT_IIR_UNROLL(P)                                                 \
static void iir_arr_##P(const double* x, size_t n, const double* nc,      \
                        const double* dc, double* xz, double* yz,         \
                        int opt, double* y) {                             \
    double xs[P], ys[P];                                                  \
    for (int i = 0; i < P; ++i) { xs[i] = xz[i]; ys[i] = yz[i]; }         \
    if (opt) {                                                            \
        for (size_t t = 0; t < n; ++t) {                                  \
            for (int i = P - 1; i > 0; --i) {                             \
                xs[i] = xs[i - 1];                                        \
                ys[i] = ys[i - 1];                                        \
            }                                                             \
            xs[0] = x[t];                                                 \
            double acc = dc[0] * xs[0];                                   \
            for (int i = 1; i < P; ++i) acc = acc + dc[i] * xs[i];        \
            for (int i = 1; i < P; ++i) acc = acc - nc[i] * ys[i];        \
            ys[0] = acc;                                                  \
            y[t] = acc;                                                   \
        }                                                                 \
    } else {                                                              \
        for (size_t t = 0; t < n; ++t) {                                  \
            for (int i = P - 1; i > 0; --i) {                             \
                xs[i] = xs[i - 1];                                        \
                ys[i] = ys[i - 1];                                        \
            }                                                             \
            xs[0] = x[t];                                                 \
            double acc = dc[0] * xs[0];                                   \
            for (int i = 1; i < P; ++i) {                                 \
                acc += dc[i] * xs[i];                                     \
                acc -= nc[i] * ys[i];                                     \
            }                                                             \
            ys[0] = acc;                                                  \
            y[t] = acc;                                                   \
        }                                                                 \
    }                                                                     \
    for (int i = 0; i < P; ++i) { xz[i] = xs[i]; yz[i] = ys[i]; }         \
}

RPT_IIR_UNROLL(2)
RPT_IIR_UNROLL(3)
RPT_IIR_UNROLL(4)
RPT_IIR_UNROLL(5)

void iir_filter_array(const double* x, size_t n, const double* nc,
                      const double* dc, int p, double* xz, double* yz,
                      int opt, double* y) {
    switch (p) {
        case 2: iir_arr_2(x, n, nc, dc, xz, yz, opt, y); return;
        case 3: iir_arr_3(x, n, nc, dc, xz, yz, opt, y); return;
        case 4: iir_arr_4(x, n, nc, dc, xz, yz, opt, y); return;
        case 5: iir_arr_5(x, n, nc, dc, xz, yz, opt, y); return;
        default: break;
    }
    for (size_t t = 0; t < n; ++t) {
        for (int i = p - 1; i > 0; --i) {
            xz[i] = xz[i - 1];
            yz[i] = yz[i - 1];
        }
        xz[0] = x[t];
        double acc;
        if (opt) {
            acc = dc[0] * xz[0];
            for (int i = 1; i < p; ++i) acc = acc + dc[i] * xz[i];
            for (int i = 1; i < p; ++i) acc = acc - nc[i] * yz[i];
        } else {
            acc = dc[0] * xz[0];
            for (int i = 1; i < p; ++i) {
                acc += dc[i] * xz[i];
                acc -= nc[i] * yz[i];
            }
        }
        yz[0] = acc;
        y[t] = acc;
    }
}

}  // namespace

// ===========================================================================
// C API
// ===========================================================================

extern "C" {

uint32_t rpt_crc32c(const uint8_t* data, size_t n, uint32_t crc) {
    return crc32c(data, n, crc);
}

// The software loop alone, whatever the CPU offers (for tests).
uint32_t rpt_crc32c_sw(const uint8_t* data, size_t n, uint32_t crc) {
    return ~crc32c_sw(data, n, ~crc);
}

int rpt_crc32c_hw_ok() { return crc_hw_ok() ? 1 : 0; }

int rpt_hzr_decode(const uint8_t* in, size_t in_size, uint8_t* out,
                   size_t out_cap, size_t* consumed) {
    if (in_size < kHeaderSize) return 1;
    uint32_t total;
    memcpy(&total, in, 4);
    if (out_cap < total) return 1;
    size_t pos = kHeaderSize;
    size_t done = 0;
    while (done < total) {
        size_t bs = total - done;
        if (bs > kMaxBlockSize) bs = kMaxBlockSize;
        if (pos + kBlockHeaderSize > in_size) return 1;
        uint16_t esz_m1;
        memcpy(&esz_m1, in + pos, 2);
        size_t esz = (size_t)esz_m1 + 1;
        uint8_t mode = in[pos + 6];
        pos += kBlockHeaderSize;
        if (mode == kModeCopy) {
            if (esz != bs || pos + bs > in_size) return 1;
            memcpy(out + done, in + pos, bs);
            pos += bs;
        } else if (mode == kModeFill) {
            if (pos + 1 > in_size) return 1;
            memset(out + done, in[pos], bs);
            pos += 1;
        } else if (mode == kModeHuffRle) {
            if (pos + esz > in_size) return 1;
            if (decode_block_payload(in + pos, esz, out + done, bs)) return 1;
            pos += esz;
        } else {
            return 1;
        }
        done += bs;
    }
    if (consumed) *consumed = pos;
    return 0;
}

int rpt_hzr_verify(const uint8_t* in, size_t in_size, size_t* decoded_size) {
    if (in_size < kHeaderSize) return 1;
    uint32_t total;
    memcpy(&total, in, 4);
    *decoded_size = total;
    size_t pos = kHeaderSize;
    size_t done = 0;
    while (done < total) {
        size_t bs = total - done;
        if (bs > kMaxBlockSize) bs = kMaxBlockSize;
        if (pos + kBlockHeaderSize > in_size) return 1;
        uint16_t esz_m1;
        memcpy(&esz_m1, in + pos, 2);
        size_t esz = (size_t)esz_m1 + 1;
        uint32_t want;
        memcpy(&want, in + pos + 2, 4);
        uint8_t mode = in[pos + 6];
        if (mode > kModeFill) return 1;
        pos += kBlockHeaderSize;
        size_t adv = (mode == kModeFill) ? 1 : esz;
        if (pos + adv > in_size) return 1;
        if (crc32c(in + pos, mode == kModeFill ? 1 : esz) != want) return 1;
        pos += adv;
        done += bs;
    }
    return 0;
}

int rpt_declutnib_batch(const uint8_t* buf, const int64_t* offs,
                        const int64_t* lens, int nb, int32_t* l1s,
                        int32_t* lvls, int32_t* nslots, int32_t* dbits,
                        int32_t* ok, int cap_slots, int nthreads) {
    if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
    std::atomic<int> next(0);
    auto work = [&](size_t, size_t) {
        int i;
        while ((i = next.fetch_add(1)) < nb) {
            ok[i] = declutnib_one(
                buf + offs[i], (size_t)lens[i], l1s + (size_t)i * 256,
                lvls + (size_t)i * 4 * (size_t)cap_slots * 16,
                nslots + (size_t)i * 4, cap_slots, dbits + i);
        }
    };
    pool_ranges((size_t)(nthreads < nb ? nthreads : nb),
                (size_t)(nthreads < nb ? nthreads : nb),
                [&](size_t a, size_t b2) { work(a, b2); });
    return 0;
}

// Block-parallel hzr decode: hop the 7-byte headers to find each
// 64 KiB block's offset (cheap, serial), then decode all blocks
// concurrently — the block independence the format guarantees
// (hzr_encode.c:528-539 re-derives the tree per block).
int rpt_hzr_decode_blocks_mt(const uint8_t* in, size_t in_len, uint8_t* out,
                             size_t out_cap, int nthreads) {
    if (in_len < kHeaderSize) return 1;
    uint32_t total;
    memcpy(&total, in, 4);
    if (total > out_cap) return 1;
    if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
    // header hop
    std::vector<size_t> in_off, out_off, blens;
    size_t pos = kHeaderSize, left = total, opos = 0;
    while (left > 0) {
        size_t blen = left < kMaxBlockSize ? left : kMaxBlockSize;
        if (pos + kBlockHeaderSize > in_len) return 1;
        uint16_t sz;
        memcpy(&sz, in + pos, 2);
        uint8_t mode = in[pos + 6];
        in_off.push_back(pos);
        out_off.push_back(opos);
        blens.push_back(blen);
        size_t payload = (mode == kModeFill) ? 1 : (size_t)sz + 1;
        pos += kBlockHeaderSize + payload;
        opos += blen;
        left -= blen;
    }
    // every payload ends by the last one's end: none may pass the input
    if (pos > in_len) return 1;
    int nb = (int)in_off.size();
    std::vector<int> rcs(nb, 0);
    std::atomic<int> next(0);
    auto work = [&]() {
        int i;
        while ((i = next.fetch_add(1)) < nb) {
            size_t p = in_off[i];
            uint16_t sz;
            memcpy(&sz, in + p, 2);
            uint8_t mode = in[p + 6];
            const uint8_t* payload = in + p + kBlockHeaderSize;
            uint8_t* dst = out + out_off[i];
            size_t blen = blens[i];
            if (mode == kModeCopy) {
                if ((size_t)sz + 1 != blen) { rcs[i] = 1; continue; }
                memcpy(dst, payload, blen);
            } else if (mode == kModeFill) {
                memset(dst, payload[0], blen);
            } else if (mode == kModeHuffRle) {
                if (decode_block_payload(payload, (size_t)sz + 1, dst, blen))
                    rcs[i] = 1;
            } else rcs[i] = 1;
        }
    };
    if (nthreads <= 1 || nb <= 1) {
        work();
    } else {
        int nt = nthreads < nb ? nthreads : nb;
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; ++t) ts.emplace_back(work);
        for (auto& t : ts) t.join();
    }
    for (int i = 0; i < nb; ++i)
        if (rcs[i]) return 1;
    return 0;
}

// All planes × all blocks at once (the packers' host decompress:
// nplanes chunks each [u32 len][hzr stream], each stream decoding to
// exactly plane_len bytes). Every chunk is checked before any thread
// starts, so a bad one returns with no thread left running.
int rpt_decode_planes_blocks_mt(const uint8_t* in, size_t in_len, int nplanes,
                                size_t plane_len, uint8_t* planes,
                                size_t* consumed, int nthreads) {
    if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
    size_t pos = 0;
    std::vector<int> rcs(nplanes, 0);
    std::vector<size_t> starts(nplanes), lens(nplanes);
    for (int k = 0; k < nplanes; ++k) {
        if (pos + 4 > in_len) return 1;
        uint32_t l32;
        memcpy(&l32, in + pos, 4);
        pos += 4;
        if (pos + l32 > in_len) return 1;
        uint32_t total;
        if (l32 < kHeaderSize) return 1;
        memcpy(&total, in + pos, 4);
        if (total != plane_len) return 1;
        starts[k] = pos;
        lens[k] = l32;
        pos += l32;
    }
    std::vector<std::thread> ts;
    for (int k = 0; k < nplanes; ++k) {
        const uint8_t* s = in + starts[k];
        size_t l32 = lens[k];
        uint8_t* d = planes + (size_t)k * plane_len;
        int per = nthreads / nplanes > 0 ? nthreads / nplanes : 1;
        ts.emplace_back([s, l32, d, plane_len, per, &rcs, k] {
            rcs[k] = rpt_hzr_decode_blocks_mt(s, l32, d, plane_len, per);
        });
    }
    for (auto& t : ts) t.join();
    *consumed = pos;
    for (int k = 0; k < nplanes; ++k)
        if (rcs[k]) return 1;
    return 0;
}

// Batched Huffman table build for the two-pass encoder
// (rspt_tpu_torch/hzr/torch_coder.host_tables): per block, build the
// reference-exact greedy tree (hzr_encode.c:222-283) from a 261-bin histogram and emit
// the code LUT + host-packed preorder tree description.
//   hists:      (nb, 261) u32
//   codes:      (nb, 261) u32 out
//   cbits:      (nb, 261) i32 out
//   desc_bytes: (nb, desc_stride) u8 out (zero-padded)
//   desc_bits:  (nb,) i32 out — description length in bits
//   is_fill:    (nb,) u8 out — 1 when the block is single-code FILL
int rpt_build_tables(const uint32_t* hists, int nb,
                     uint32_t* codes, int32_t* cbits,
                     uint8_t* desc_bytes, size_t desc_stride,
                     int32_t* desc_bits, uint8_t* is_fill, int nthreads) {
    if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
    std::vector<int> rcs(nb, 0);
    auto work = [&](int lo, int hi) {
        for (int i = lo; i < hi; ++i) {
            const uint32_t* hist = hists + (size_t)i * kNumSyms;
            uint32_t* cod = codes + (size_t)i * kNumSyms;
            int32_t* cbt = cbits + (size_t)i * kNumSyms;
            uint8_t* db = desc_bytes + (size_t)i * desc_stride;
            memset(cod, 0, kNumSyms * sizeof(uint32_t));
            memset(cbt, 0, kNumSyms * sizeof(int32_t));
            memset(db, 0, desc_stride);
            desc_bits[i] = 0;
            if (only_single_code(hist)) { is_fill[i] = 1; continue; }
            is_fill[i] = 0;
            TreeCtx tree;
            build_tree(hist, tree);
            if (tree.root < 0) { is_fill[i] = 1; continue; }
            uint32_t c32[kNumSyms];
            uint8_t cb8[kNumSyms];
            memset(c32, 0, sizeof(c32));
            memset(cb8, 0, sizeof(cb8));
            BitWriter bw(db, desc_stride);
            store_tree(tree, bw, c32, cb8);
            if (bw.failed) { rcs[i] = 1; continue; }
            int nbits_partial = (int)(bw.bit_count());
            bw.flush_partial();
            desc_bits[i] = nbits_partial;
            for (int s = 0; s < kNumSyms; ++s) {
                cod[s] = c32[s];
                cbt[s] = cb8[s];
            }
        }
    };
    if (nthreads <= 1 || nb <= 1) {
        work(0, nb);
    } else {
        int nt = nthreads < nb ? nthreads : nb;
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; ++t)
            ts.emplace_back(work, nb * t / nt, nb * (t + 1) / nt);
        for (auto& t : ts) t.join();
    }
    for (int i = 0; i < nb; ++i)
        if (rcs[i]) return 1;
    return 0;
}

// One channel's serial IIR over n samples (see iir_filter_array); the
// state xz / yz (p doubles each) is updated in place.
void rpt_iir_filter_array(const double* x, size_t n, const double* nc,
                          const double* dc, int p, double* xz, double* yz,
                          int opt, double* y) {
    iir_filter_array(x, n, nc, dc, p, xz, yz, opt, y);
}

// All ch channels of x (ch, n) in one call, a channel a thread at most
// (nthreads <= 0: the CPU's threads): each channel's recurrence is
// rpt_iir_filter_array's, so threads change no bit. xz / yz: (ch, p).
void rpt_iir_filter_channels(const double* x, size_t ch, size_t n,
                             const double* nc, const double* dc, int p,
                             double* xz, double* yz, int opt, double* y,
                             int nthreads) {
    if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
    auto work = [&](size_t j0, size_t j1) {
        for (size_t j = j0; j < j1; ++j)
            iir_filter_array(x + j * n, n, nc, dc, p, xz + j * (size_t)p,
                             yz + j * (size_t)p, opt, y + j * n);
    };
    if (nthreads <= 1 || ch <= 1) {
        work(0, ch);
    } else {
        size_t nt = (size_t)nthreads < ch ? (size_t)nthreads : ch;
        std::vector<std::thread> ts;
        for (size_t t = 0; t < nt; ++t)
            ts.emplace_back(work, ch * t / nt, ch * (t + 1) / nt);
        for (auto& th : ts) th.join();
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// LZ4 block codec, the plane backend of the packers' plane_backend='lz4'
// and 'lz4hc' (the copy of rspt_tpu/native/rspt_native.cpp:2804-3160).
//
// Format (the public LZ4 block format):
//   sequence := token(1B: hi nibble literal_len, lo nibble match_len-4)
//               [literal_len ext: 255* then <255] literals
//               offset(2B LE, 1..65535) [match_len ext: 255* then <255]
//   last sequence is literals-only; the encoders keep the final 5 bytes
//   as literals and start no match within the final 12 bytes.
// The greedy and HC encoders write the reference's bytes; the HC hash
// chain takes each position once (a watermark), where the reference can
// link a position into its own chain again and form a cycle.
// ---------------------------------------------------------------------------

namespace {
namespace lz4blk {

constexpr int kHashLog = 16;
constexpr size_t kMinMatch = 4;
constexpr size_t kLastLiterals = 5;
constexpr size_t kMfLimit = 12;
constexpr size_t kMaxOffset = 65535;

static inline uint32_t rd32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

static inline uint32_t hash4(uint32_t v) {
    return (v * 2654435761u) >> (32 - kHashLog);
}

// 5-byte hash: fewer collisions than 4-byte on low-entropy data, so the
// stored candidate is likelier to extend into a long match.
static inline uint32_t hash5(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return (uint32_t)(((v << 24) * 889523592379ull) >> (64 - kHashLog));
}

// Length of the common prefix of [a, alimit) and the run at b (b < a).
static inline size_t run_fwd(const uint8_t* a, const uint8_t* b,
                             const uint8_t* alimit) {
    const uint8_t* a0 = a;
    while (a + 8 <= alimit) {
        uint64_t xa, xb;
        std::memcpy(&xa, a, 8);
        std::memcpy(&xb, b, 8);
        uint64_t x = xa ^ xb;
        if (x) return (size_t)(a - a0) + ((size_t)__builtin_ctzll(x) >> 3);
        a += 8;
        b += 8;
    }
    while (a < alimit && *a == *b) {
        ++a;
        ++b;
    }
    return (size_t)(a - a0);
}

// A length nibble's extension bytes: 255* then a byte < 255.
static inline uint8_t* put_ext(uint8_t* op, size_t l) {
    while (l >= 255) {
        *op++ = 255;
        l -= 255;
    }
    *op++ = (uint8_t)l;
    return op;
}

// The last, literals-only sequence [anchor, iend); the stream's size, or
// 0 if dst is too small.
static long long emit_last(const uint8_t* anchor, const uint8_t* iend,
                           uint8_t* op, uint8_t* oend, uint8_t* dst) {
    size_t lit = (size_t)(iend - anchor);
    if ((size_t)(oend - op) < 1 + lit / 255 + 1 + lit) return 0;
    if (lit >= 15) {
        *op++ = 0xF0;
        op = put_ext(op, lit - 15);
    } else {
        *op++ = (uint8_t)(lit << 4);
    }
    std::memcpy(op, anchor, lit);
    op += lit;
    return (long long)(op - dst);
}

// One sequence: the literals [anchor, ip), then a match of mlen at
// offset off. Returns the new output position, or nullptr if the
// sequence and a last one of kLastLiterals bytes might not fit.
static uint8_t* emit_seq(uint8_t* op, uint8_t* oend, const uint8_t* anchor,
                         const uint8_t* ip, size_t mlen, size_t off) {
    size_t lit = (size_t)(ip - anchor);
    size_t need = 1 + lit / 255 + 1 + lit + 2 + (mlen - kMinMatch) / 255 +
                  1 + kLastLiterals + 2;
    if ((size_t)(oend - op) < need) return nullptr;
    uint8_t* token = op++;
    if (lit >= 15) {
        *token = 0xF0;
        op = put_ext(op, lit - 15);
    } else {
        *token = (uint8_t)(lit << 4);
    }
    std::memcpy(op, anchor, lit);
    op += lit;
    uint16_t off16 = (uint16_t)off;
    std::memcpy(op, &off16, 2);
    op += 2;
    size_t m = mlen - kMinMatch;
    if (m >= 15) {
        *token |= 15;
        op = put_ext(op, m - 15);
    } else {
        *token |= (uint8_t)m;
    }
    return op;
}

// Greedy hash-table compressor (LZ4_compress_default class).
long long compress_greedy(const uint8_t* src, size_t n, uint8_t* dst,
                          size_t cap) {
    uint8_t* op = dst;
    uint8_t* const oend = dst + cap;
    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    const uint8_t* anchor = src;
    if (n <= kMfLimit) return emit_last(anchor, iend, op, oend, dst);

    std::vector<uint32_t> htab((size_t)1 << kHashLog, 0);
    const uint8_t* const mflimit = iend - kMfLimit;
    const uint8_t* const matchlimit = iend - kLastLiterals;

    htab[hash5(ip)] = 0;
    ++ip;

    for (;;) {
        // -- find a match (skip-accelerated probe) --
        const uint8_t* cand;
        uint32_t probes = 1u << 6;
        for (;;) {
            if (ip > mflimit) return emit_last(anchor, iend, op, oend, dst);
            uint32_t h = hash5(ip);
            cand = src + htab[h];
            htab[h] = (uint32_t)(ip - src);
            if (cand < ip && (size_t)(ip - cand) <= kMaxOffset &&
                rd32(cand) == rd32(ip))
                break;
            ip += (probes++ >> 6);
        }
        // -- extend backwards over pending literals --
        while (ip > anchor && cand > src && ip[-1] == cand[-1]) {
            --ip;
            --cand;
        }
        size_t mlen =
            kMinMatch + run_fwd(ip + kMinMatch, cand + kMinMatch, matchlimit);
        op = emit_seq(op, oend, anchor, ip, mlen, (size_t)(ip - cand));
        if (!op) return 0;
        ip += mlen;
        anchor = ip;
        if (ip > mflimit) return emit_last(anchor, iend, op, oend, dst);
        // refresh the table near the match tail so runs keep chaining
        htab[hash5(ip - 2)] = (uint32_t)(ip - 2 - src);
    }
}

// High-compression variant (LZ4HC class): depth-bounded hash-chain
// candidate search with one-step lazy matching. Each position enters its
// hash chain once: after a backward extension the reference inserts the
// positions it walked back over again and can link one into its own
// chain (a cycle); here a position at or below the highest inserted one
// is skipped, so the chains stay in decreasing order.
long long compress_hc(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                      int depth) {
    if (depth <= 0) depth = 256;
    uint8_t* op = dst;
    uint8_t* const oend = dst + cap;
    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    const uint8_t* anchor = src;
    if (n <= kMfLimit) return emit_last(anchor, iend, op, oend, dst);
    const uint8_t* const mflimit = iend - kMfLimit;
    const uint8_t* const matchlimit = iend - kLastLiterals;

    std::vector<int32_t> head((size_t)1 << kHashLog, -1);
    std::vector<int32_t> chain(n, -1);
    int32_t inserted = -1;     // the highest position in a chain
    auto insert = [&](const uint8_t* p) {
        int32_t pos = (int32_t)(p - src);
        if (pos <= inserted) return;
        uint32_t h = hash4(rd32(p));
        chain[pos] = head[h];
        head[h] = pos;
        inserted = pos;
    };
    auto best_match = [&](const uint8_t* p,
                          const uint8_t** bcand) -> size_t {
        size_t best = 0;
        int32_t cand = head[hash4(rd32(p))];
        int d = depth;
        while (cand >= 0 && d-- > 0) {
            const uint8_t* cp = src + cand;
            if ((size_t)(p - cp) > kMaxOffset) break;  // older = farther
            if (rd32(cp) == rd32(p)) {
                size_t len = kMinMatch + run_fwd(p + kMinMatch,
                                                 cp + kMinMatch, matchlimit);
                if (len > best) {
                    best = len;
                    *bcand = cp;
                }
            }
            cand = chain[cand];
        }
        return best >= kMinMatch ? best : 0;
    };

    insert(ip);
    ++ip;
    while (ip <= mflimit) {
        const uint8_t* cand = nullptr;
        size_t mlen = best_match(ip, &cand);
        if (!mlen) {
            insert(ip);
            ++ip;
            continue;
        }
        // one-step lazy deferral: a strictly longer match starting one
        // byte later buys more than the literal it costs
        while (ip + 1 <= mflimit) {
            insert(ip);
            const uint8_t* cand2 = nullptr;
            size_t m2 = best_match(ip + 1, &cand2);
            if (m2 > mlen + 1) {
                ++ip;
                mlen = m2;
                cand = cand2;
            } else {
                break;
            }
        }
        while (ip > anchor && cand > src && ip[-1] == cand[-1]) {
            --ip;
            --cand;
        }
        op = emit_seq(op, oend, anchor, ip, mlen, (size_t)(ip - cand));
        if (!op) return 0;
        // index every position the match covered (what makes HC find
        // overlapping candidates the greedy single-slot table misses)
        const uint8_t* stop = ip + mlen < mflimit ? ip + mlen : mflimit;
        for (const uint8_t* p2 = ip + 1; p2 < stop; ++p2) insert(p2);
        ip += mlen;
        anchor = ip;
    }
    return emit_last(anchor, iend, op, oend, dst);
}

// Bounds-checked decompressor (LZ4_decompress_safe class): the decoded
// size, or -1 on malformed input or overflow.
long long decompress(const uint8_t* src, size_t n, uint8_t* dst,
                     size_t cap) {
    if (n == 0) return -1;
    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    uint8_t* op = dst;
    uint8_t* const oend = dst + cap;

    for (;;) {
        if (ip >= iend) return -1;
        uint32_t token = *ip++;
        size_t lit = token >> 4;
        if (lit == 15) {
            uint32_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                lit += b;
            } while (b == 255);
        }
        if ((size_t)(iend - ip) < lit || (size_t)(oend - op) < lit) return -1;
        std::memcpy(op, ip, lit);
        op += lit;
        ip += lit;
        if (ip == iend) break;  // last sequence: literals only

        if ((size_t)(iend - ip) < 2) return -1;
        uint16_t off16;
        std::memcpy(&off16, ip, 2);
        ip += 2;
        size_t off = off16;
        if (off == 0 || (size_t)(op - dst) < off) return -1;

        size_t mlen = (token & 15) + kMinMatch;
        if ((token & 15) == 15) {
            uint32_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                mlen += b;
            } while (b == 255);
        }
        if ((size_t)(oend - op) < mlen) return -1;
        const uint8_t* mp = op - off;
        if (off >= 8) {
            size_t i = 0;
            for (; i + 8 <= mlen; i += 8) std::memcpy(op + i, mp + i, 8);
            for (; i < mlen; ++i) op[i] = mp[i];
        } else {
            for (size_t i = 0; i < mlen; ++i) op[i] = mp[i];
        }
        op += mlen;
    }
    return (long long)(op - dst);
}

size_t max_compressed(size_t n) { return n + n / 255 + 16; }

// fn(k) for k in [0, m) on the pool, a plane a slot; false if any call
// threw (an allocation that failed).
bool each_plane(int m, const std::function<void(int)>& fn) {
    std::atomic<bool> ok{true};
    std::function<void(int)> slot = [&](int k) {
        try {
            fn(k);
        } catch (...) {
            ok.store(false);
        }
    };
    ThreadPool::inst().run(m, slot);
    return ok.load();
}

}  // namespace lz4blk
}  // namespace

extern "C" {

long long rpt_lz4_max_compressed(long long n) {
    return (long long)lz4blk::max_compressed((size_t)n);
}

// Greedy compress of src[0, n) into dst[0, cap): the stream's size, or 0
// if dst is too small.
long long rpt_lz4_compress(const uint8_t* src, long long n, uint8_t* dst,
                           long long cap) {
    if (n < 0 || cap <= 0) return 0;
    try {
        return lz4blk::compress_greedy(src, (size_t)n, dst, (size_t)cap);
    } catch (...) {
        return 0;
    }
}

// HC compress (hash chains depth entries deep, 256 if depth <= 0).
long long rpt_lz4_compress_hc(const uint8_t* src, long long n, uint8_t* dst,
                              long long cap, int depth) {
    if (n < 0 || cap <= 0) return 0;
    try {
        return lz4blk::compress_hc(src, (size_t)n, dst, (size_t)cap, depth);
    } catch (...) {
        return 0;
    }
}

// Decode of src[0, n) into dst[0, cap): the decoded size, or -1.
long long rpt_lz4_decompress(const uint8_t* src, long long n, uint8_t* dst,
                             long long cap) {
    if (n <= 0 || cap < 0) return -1;
    return lz4blk::decompress(src, (size_t)n, dst, (size_t)cap);
}

// Every plane of a container (or of several) in one call, a plane a
// pool slot: plane k = planes[k * plane_len, (k + 1) * plane_len) goes to
// out[k * rpt_lz4_max_compressed(plane_len), ...), its size to
// out_lens[k]; hc selects compress_hc at its default depth (256). Each
// plane's bytes are the single-plane call's. Returns 0, or 1 if a plane
// failed.
int rpt_lz4_encode_planes(const uint8_t* planes, int nplanes,
                          size_t plane_len, int hc, uint8_t* out,
                          long long* out_lens) {
    if (nplanes < 0) return 1;
    const size_t cap = lz4blk::max_compressed(plane_len);
    bool ok = lz4blk::each_plane(nplanes, [&](int k) {
        const uint8_t* src = planes + (size_t)k * plane_len;
        uint8_t* dst = out + (size_t)k * cap;
        out_lens[k] = hc ? lz4blk::compress_hc(src, plane_len, dst, cap, 0)
                         : lz4blk::compress_greedy(src, plane_len, dst, cap);
    });
    if (!ok) return 1;
    for (int k = 0; k < nplanes; ++k)
        if (out_lens[k] <= 0) return 1;
    return 0;
}

// A container's plane section — nplanes times [u32 length][LZ4 block of
// plane_len bytes] — decoded a plane a pool slot into planes
// (nplanes, plane_len). Every length is checked before any plane is
// decoded. Returns 0 with *consumed the section's bytes, or 1 on a
// truncated section or a plane that is malformed or does not decode to
// exactly plane_len bytes.
int rpt_lz4_decode_planes(const uint8_t* in, size_t in_len, int nplanes,
                          size_t plane_len, uint8_t* planes,
                          size_t* consumed) {
    if (nplanes < 0) return 1;
    std::vector<size_t> starts(nplanes), lens(nplanes);
    size_t pos = 0;
    for (int k = 0; k < nplanes; ++k) {
        if (in_len - pos < 4) return 1;
        uint32_t l32;
        std::memcpy(&l32, in + pos, 4);
        pos += 4;
        if (in_len - pos < l32) return 1;
        starts[k] = pos;
        lens[k] = l32;
        pos += l32;
    }
    std::vector<long long> got(nplanes, -1);
    bool ok = lz4blk::each_plane(nplanes, [&](int k) {
        got[k] = lz4blk::decompress(in + starts[k], lens[k],
                                    planes + (size_t)k * plane_len,
                                    plane_len);
    });
    if (!ok) return 1;
    for (int k = 0; k < nplanes; ++k)
        if (got[k] != (long long)plane_len) return 1;
    *consumed = pos;
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The encode half of the all-host engine (packers/native.py), copied from
// rspt_tpu/native/rspt_native.cpp:1176-1740 and :1963-2783 with these
// changes: the xdelta plane-growth test is the port's rule (planes_keep),
// not "every value sign-extends from N bytes"; every f64 -> int32
// conversion is x86_i32; every threaded entry runs on the serialized pool
// and returns an error code; no environment knob and no thread_local
// arena.
// ---------------------------------------------------------------------------

namespace {

// Four channels' serial IIRs advanced through one loop, each with its own
// register state: their f64 dependency chains interleave in the pipeline.
// Each channel's operation order is iir_arr_P's, so its bits are too.
#define RPT_IIR_UNROLL4(P)                                                \
static void iir_arr4_##P(const double* const* xs4, size_t n,              \
                         const double* nc, const double* dc,              \
                         double* const* xz4, double* const* yz4,          \
                         int opt, double* const* ys4) {                   \
    double xs[4][P], ys[4][P];                                            \
    for (int c = 0; c < 4; ++c)                                           \
        for (int i = 0; i < P; ++i) {                                     \
            xs[c][i] = xz4[c][i];                                         \
            ys[c][i] = yz4[c][i];                                         \
        }                                                                 \
    for (size_t t = 0; t < n; ++t) {                                      \
        double acc[4];                                                    \
        for (int c = 0; c < 4; ++c) {                                     \
            for (int i = P - 1; i > 0; --i) {                             \
                xs[c][i] = xs[c][i - 1];                                  \
                ys[c][i] = ys[c][i - 1];                                  \
            }                                                             \
            xs[c][0] = xs4[c][t];                                         \
            acc[c] = dc[0] * xs[c][0];                                    \
        }                                                                 \
        if (opt) {                                                        \
            for (int i = 1; i < P; ++i)                                   \
                for (int c = 0; c < 4; ++c)                               \
                    acc[c] = acc[c] + dc[i] * xs[c][i];                   \
            for (int i = 1; i < P; ++i)                                   \
                for (int c = 0; c < 4; ++c)                               \
                    acc[c] = acc[c] - nc[i] * ys[c][i];                   \
        } else {                                                          \
            for (int i = 1; i < P; ++i)                                   \
                for (int c = 0; c < 4; ++c) {                             \
                    acc[c] += dc[i] * xs[c][i];                           \
                    acc[c] -= nc[i] * ys[c][i];                           \
                }                                                         \
        }                                                                 \
        for (int c = 0; c < 4; ++c) {                                     \
            ys[c][0] = acc[c];                                            \
            ys4[c][t] = acc[c];                                           \
        }                                                                 \
    }                                                                     \
    for (int c = 0; c < 4; ++c)                                           \
        for (int i = 0; i < P; ++i) {                                     \
            xz4[c][i] = xs[c][i];                                         \
            yz4[c][i] = ys[c][i];                                         \
        }                                                                 \
}

RPT_IIR_UNROLL4(2)
RPT_IIR_UNROLL4(3)
RPT_IIR_UNROLL4(4)
RPT_IIR_UNROLL4(5)

// A group of nch <= 4 channels: interleaved when there are 4 and the
// order has a fixed body, else channel by channel.
void iir_channels4(const double* const* xs4, size_t nch, size_t n,
                   const double* nc, const double* dc, int p,
                   double* const* xz4, double* const* yz4, int opt,
                   double* const* ys4) {
    if (nch == 4) {
        switch (p) {
            case 2: iir_arr4_2(xs4, n, nc, dc, xz4, yz4, opt, ys4); return;
            case 3: iir_arr4_3(xs4, n, nc, dc, xz4, yz4, opt, ys4); return;
            case 4: iir_arr4_4(xs4, n, nc, dc, xz4, yz4, opt, ys4); return;
            case 5: iir_arr4_5(xs4, n, nc, dc, xz4, yz4, opt, ys4); return;
            default: break;
        }
    }
    for (size_t c = 0; c < nch; ++c)
        iir_filter_array(xs4[c], n, nc, dc, p, xz4[c], yz4[c], opt, ys4[c]);
}

// One little-endian bps-byte sample, sign-extended.
inline int32_t load_sample(const uint8_t* q, size_t bps) {
    uint32_t v = 0;
    for (size_t k = 0; k < bps; ++k) v |= (uint32_t)q[k] << (8 * k);
    return sext(v, 8 * (int)bps);
}

// The xdelta values of a flat int32 run (delta from 0, offset -128, xor
// with the previous delta) written as npl byte planes of stride
// plane_stride, from v[lo] on (v[lo - 1], v[lo - 2] read where they
// exist). Returns whether npl planes keep every bps-byte sample.
bool xdelta_planes(const int32_t* v, size_t lo, size_t hi, int npl, int bps,
                   uint8_t* planes, size_t plane_stride) {
    uint32_t vm1 = lo >= 1 ? (uint32_t)v[lo - 1] : 0u;
    uint32_t vm2 = lo >= 2 ? (uint32_t)v[lo - 2] : 0u;
    bool fits = true;
    for (size_t i = lo; i < hi; ++i) {
        uint32_t vi = (uint32_t)v[i];
        uint32_t d = vi - vm1 - 128u;
        uint32_t dm1 = i >= 1 ? vm1 - vm2 - 128u : 0u;
        uint32_t x = d ^ dm1;
        fits &= planes_keep(x, npl, bps);
        for (int k = 0; k < npl; ++k)
            planes[(size_t)k * plane_stride + i] = (uint8_t)(x >> (8 * k));
        vm2 = vm1;
        vm1 = vi;
    }
    return fits;
}

// DCT-II / its inverse a tile of kDctTile outputs at a time: each output
// a serial f64 sum over x of float products, in the reference's order
// (signal_packer_dct.cpp:76-100, rspt_native.cpp:1313-1349).
constexpr int kDctTile = 16;

void dct_fwd_tile(const int32_t* src, int32_t* dst, const float* cosines,
                  const float* cs, int n, double quality, double ratio1,
                  int i0, int i1) {
    double acc[kDctTile];
    for (int t = 0; t < i1 - i0; ++t) acc[t] = 0;
    for (int x = 0; x < n; ++x) {
        float s = (float)src[x];
        const float* row = cosines + (size_t)x * n + i0;
        for (int t = 0; t < i1 - i0; ++t) acc[t] += (double)(s * row[t]);
    }
    for (int t = 0; t < i1 - i0; ++t) {
        double sum = acc[t];
        sum *= cs[i0 + t] * ratio1 / quality;
        dst[i0 + t] = x86_i32(sum);
    }
}

void dct_inv_tile(const float* q, int32_t* out, const float* cosines_t,
                  int n, double quality, double ratio1, int i0, int i1) {
    double acc[kDctTile];
    for (int t = 0; t < i1 - i0; ++t) acc[t] = 0;
    for (int x = 0; x < n; ++x) {
        float s = q[x];
        const float* row = cosines_t + (size_t)x * n + i0;
        for (int t = 0; t < i1 - i0; ++t) acc[t] += (double)(s * row[t]);
    }
    for (int t = 0; t < i1 - i0; ++t) {
        double sum = acc[t];
        sum *= ratio1 * quality;
        out[i0 + t] = x86_i32(sum);
    }
}

// FWHT of one row of n = 2^k values, int32 wraparound butterflies
// (lib_fwht/fwht.c:4-28, rspt_native.cpp:1398-1416).
void fwht_row(const int32_t* src, int32_t* dst, int32_t* other, int n) {
    const int32_t* a = src;
    int32_t* b = dst;
    for (int i = n >> 1; i > 0; i >>= 1) {
        for (int base = 0; base < n; base += 2 * i) {
            for (int j = 0; j < i; ++j) {
                uint32_t u = (uint32_t)a[base + j];
                uint32_t v = (uint32_t)a[base + i + j];
                b[base + j] = (int32_t)(u + v);
                b[base + i + j] = (int32_t)(u - v);
            }
        }
        if (a == src) { a = b; b = other; }
        else { int32_t* t = (int32_t*)a; a = b; b = t; }
    }
    if (a != dst) memcpy(dst, a, sizeof(int32_t) * n);
}

}  // namespace

extern "C" {

// The threads a call runs on at nthreads = 0 (the pool's workers and the
// caller).
int rpt_threads() { return resolve_threads(0); }

size_t rpt_hzr_max_size(size_t n) { return hzr_max_size(n); }

// One hzr stream of in[0, in_size): [u32 size][blocks], block after
// block. Returns 0 with *out_len its size, or 1 if cap is too small.
int rpt_hzr_encode(const uint8_t* in, size_t in_size, uint8_t* out,
                   size_t cap, size_t* out_len) {
    if (cap < kHeaderSize || in_size > 0xFFFFFFFFu) return 1;
    uint32_t sz = (uint32_t)in_size;
    memcpy(out, &sz, 4);
    size_t pos = kHeaderSize;
    for (size_t start = 0; start < in_size; start += kMaxBlockSize) {
        size_t bs = in_size - start;
        if (bs > kMaxBlockSize) bs = kMaxBlockSize;
        size_t e = encode_block(in + start, bs, out + pos, cap - pos);
        if (e == 0) return 1;
        pos += e;
    }
    *out_len = pos;
    return 0;
}

// --- scans, int32 wraparound (utils.cpp:193-236) ---------------------------

void rpt_delta_encode(int32_t* a, size_t n) {
    uint32_t last = 0;
    for (size_t i = 0; i < n; ++i) {
        uint32_t cur = (uint32_t)a[i];
        a[i] = (int32_t)(cur - last);
        last = cur;
    }
}

void rpt_delta_decode(int32_t* a, size_t n) {
    uint32_t last = 0;
    for (size_t i = 0; i < n; ++i) {
        last += (uint32_t)a[i];
        a[i] = (int32_t)last;
    }
}

void rpt_offset32(int32_t* a, size_t n, int32_t v) {
    for (size_t i = 0; i < n; ++i)
        a[i] = (int32_t)((uint32_t)a[i] + (uint32_t)v);
}

void rpt_xor_encode(int32_t* a, size_t n) {
    int32_t last = 0;
    for (size_t i = 0; i < n; ++i) {
        int32_t d = last ^ a[i];
        last = a[i];
        a[i] = d;
    }
}

void rpt_xor_decode(int32_t* a, size_t n) {
    for (size_t i = 1; i < n; ++i) a[i] = a[i - 1] ^ a[i];
}

// --- layout swizzles (utils.cpp:51-191) and byte planes --------------------

// Interleaved little-endian bps-byte samples [s0c0][s0c1]... -> channel-
// major int32 (ch, nr_samples), sign-extended.
void rpt_native_to_i32(int32_t* dst, const uint8_t* native, size_t nr_samples,
                       size_t ch, size_t bps) {
    for (size_t s = 0; s < nr_samples; ++s)
        for (size_t c = 0; c < ch; ++c)
            dst[c * nr_samples + s] =
                load_sample(native + (s * ch + c) * bps, bps);
}

void rpt_i32_to_native(uint8_t* native, const int32_t* src, size_t nr_samples,
                       size_t ch, size_t bps) {
    for (size_t s = 0; s < nr_samples; ++s)
        for (size_t c = 0; c < ch; ++c) {
            uint32_t v = (uint32_t)src[c * nr_samples + s];
            uint8_t* p = native + (s * ch + c) * bps;
            for (size_t k = 0; k < bps; ++k) p[k] = (uint8_t)(v >> (8 * k));
        }
}

void rpt_plane_split(const int32_t* flat, size_t n, int planes, uint8_t* out) {
    for (int k = 0; k < planes; ++k) {
        uint8_t* o = out + (size_t)k * n;
        for (size_t i = 0; i < n; ++i)
            o[i] = (uint8_t)((uint32_t)flat[i] >> (8 * k));
    }
}

// Planes (p, n) -> int32, sign-extended from 8 * p bits.
void rpt_plane_merge(const uint8_t* planes, size_t n, int p, int32_t* out) {
    for (size_t i = 0; i < n; ++i) {
        uint32_t v = 0;
        for (int k = 0; k < p; ++k)
            v |= (uint32_t)planes[(size_t)k * n + i] << (8 * k);
        out[i] = sext(v, 8 * p);
    }
}

// --- threaded encode --------------------------------------------------------

// Every 64 KiB block of every plane (nplanes, plane_len) one pool item;
// plane k's chunk [u32 stream length][hzr stream] goes to out + k * stride,
// its stream length to lens[k]. Returns 0, or 1 if a chunk passes stride.
int rpt_encode_planes_blocks_mt(const uint8_t* planes, size_t plane_len,
                                int nplanes, uint8_t* out, size_t stride,
                                size_t* lens, int nthreads) {
    if (nplanes < 0 || plane_len > 0xFFFFFFFFu) return 1;
    size_t nb_per = (plane_len + kMaxBlockSize - 1) / kMaxBlockSize;
    size_t nb = nb_per * (size_t)nplanes;
    size_t bmax = plane_len < kMaxBlockSize ? plane_len : kMaxBlockSize;
    size_t bcap = bmax + kBlockHeaderSize + 16;
    std::vector<uint8_t> scratch(nb * bcap);
    std::vector<size_t> blens(nb, 0);
    pool_items(nb, nthreads, [&](size_t i) {
        size_t plane = i / nb_per;
        size_t off = (i % nb_per) * kMaxBlockSize;
        size_t blen = plane_len - off < kMaxBlockSize ? plane_len - off
                                                      : kMaxBlockSize;
        blens[i] = encode_block(planes + plane * plane_len + off, blen,
                                scratch.data() + i * bcap, bcap);
    });
    for (size_t i = 0; i < nb; ++i)
        if (!blens[i]) return 1;
    for (int p = 0; p < nplanes; ++p) {
        uint8_t* dst = out + (size_t)p * stride;
        size_t pos = 4 + kHeaderSize;  // chunk length + stream header
        if (pos > stride) return 1;
        for (size_t b = 0; b < nb_per; ++b) {
            size_t i = (size_t)p * nb_per + b;
            if (pos + blens[i] > stride) return 1;
            memcpy(dst + pos, scratch.data() + i * bcap, blens[i]);
            pos += blens[i];
        }
        uint32_t total = (uint32_t)plane_len;
        memcpy(dst + 4, &total, 4);
        uint32_t clen = (uint32_t)(pos - 4);
        memcpy(dst, &clen, 4);
        lens[p] = pos - 4;
    }
    return 0;
}

// Interleaved native samples -> nr_planes byte planes (nr_planes, ch * n)
// of their flat channel-major xdelta values, in threads over ranges of
// the flat index. Returns 1 if the planes keep every sample (the port's
// rule), 0 if not, -1 on bad arguments.
int rpt_xdelta_preprocess_mt(const uint8_t* native, size_t nr_samples,
                             size_t ch, size_t bps, int nr_planes,
                             uint8_t* planes, int nthreads) {
    if (bps < 1 || bps > 4 || nr_planes < 1 || nr_planes > 4) return -1;
    const size_t N = nr_samples * ch;
    const size_t nt = (size_t)resolve_threads(nthreads);
    std::vector<int32_t> v(N);
    pool_ranges(N, nt, [&](size_t lo, size_t hi) {
        for (size_t i = lo; i < hi; ++i)
            v[i] = load_sample(
                native + ((i % nr_samples) * ch + i / nr_samples) * bps, bps);
    });
    std::atomic<int> fit(1);
    pool_ranges(N, nt, [&](size_t lo, size_t hi) {
        if (!xdelta_planes(v.data(), lo, hi, nr_planes, (int)bps, planes, N))
            fit.store(0);
    });
    return fit.load();
}

// The inverse: byte planes -> interleaved native bytes. The decode is a
// prefix xor then a prefix sum over the flat values, run as chunk-local
// scans and carries: pass A the chunks' xor totals, pass B the deltas
// and the chunks' sums, pass C the values into the native layout.
// Returns 0, or 1 on bad arguments.
int rpt_xdelta_postprocess_mt(const uint8_t* planes, size_t nr_samples,
                              size_t ch, size_t bps, int nr_planes,
                              uint8_t* native_out, int nthreads) {
    if (bps < 1 || bps > 4 || nr_planes < 1 || nr_planes > 4) return 1;
    const size_t N = nr_samples * ch;
    if (N == 0) return 0;
    size_t nt = (size_t)resolve_threads(nthreads);
    if (nt > N) nt = N;
    std::vector<uint32_t> tmp(N);
    std::vector<uint32_t> xtot(nt, 0), stot(nt, 0);
    auto lo = [&](size_t t) { return N * t / nt; };
    auto merge_at = [&](size_t i) -> uint32_t {
        uint32_t v = 0;
        for (int k = 0; k < nr_planes; ++k)
            v |= (uint32_t)planes[(size_t)k * N + i] << (8 * k);
        return (uint32_t)sext(v, 8 * nr_planes);
    };
    auto run = [&](const std::function<void(size_t)>& fn) {
        pool_items(nt, (int)nt, fn);
    };
    run([&](size_t t) {
        uint32_t x = 0;
        for (size_t i = lo(t); i < lo(t + 1); ++i) x ^= merge_at(i);
        xtot[t] = x;
    });
    std::vector<uint32_t> xcarry(nt, 0), scarry(nt, 0);
    for (size_t t = 1; t < nt; ++t) xcarry[t] = xcarry[t - 1] ^ xtot[t - 1];
    run([&](size_t t) {
        uint32_t lx = 0, s = 0;
        for (size_t i = lo(t); i < lo(t + 1); ++i) {
            lx ^= merge_at(i);
            uint32_t d = (xcarry[t] ^ lx) + 128u;
            tmp[i] = d;
            s += d;
        }
        stot[t] = s;
    });
    for (size_t t = 1; t < nt; ++t) scarry[t] = scarry[t - 1] + stot[t - 1];
    run([&](size_t t) {
        uint32_t v = scarry[t];
        for (size_t i = lo(t); i < lo(t + 1); ++i) {
            v += tmp[i];
            uint8_t* p = native_out +
                         ((i % nr_samples) * ch + i / nr_samples) * bps;
            for (size_t k = 0; k < bps; ++k) p[k] = (uint8_t)(v >> (8 * k));
        }
    });
    return 0;
}

// --- transforms ---------------------------------------------------------------

// DCT-II of ch channel-major rows of n samples with the folded
// quantization (signal_packer_dct.cpp:76-87), threaded over (channel,
// output tile): every output's serial sum is the reference's. cosines is
// COS[i][x] stored at [i * n + x] (the forward reads [x * n + i]).
// Returns 0, or 1 on bad arguments.
int rpt_dct_forward_mt(const int32_t* src, int32_t* dst, const float* cosines,
                       const float* cs, int ch, int n, double quality,
                       int nthreads) {
    if (ch < 0 || n < 1) return 1;
    double ratio1 = __builtin_sqrt(2.0 / n);
    size_t tiles = (size_t)(n + kDctTile - 1) / kDctTile;
    pool_items((size_t)ch * tiles, nthreads, [&](size_t slot) {
        size_t c = slot / tiles;
        int i0 = (int)(slot % tiles) * kDctTile;
        int i1 = i0 + kDctTile < n ? i0 + kDctTile : n;
        dct_fwd_tile(src + c * n, dst + c * n, cosines, cs, n, quality,
                     ratio1, i0, i1);
    });
    return 0;
}

// The inverse (signal_packer_dct.cpp:89-100): cosines_t is the forward
// table transposed, so that the tile loop reads contiguous rows; each
// term's float prefactor Cs[x] * dct[x] is computed once a channel.
int rpt_dct_inverse_mt(const int32_t* dct, int32_t* out,
                       const float* cosines_t, const float* cs, int ch,
                       int n, double quality, int nthreads) {
    if (ch < 0 || n < 1) return 1;
    double ratio1 = __builtin_sqrt(2.0 / n);
    size_t tiles = (size_t)(n + kDctTile - 1) / kDctTile;
    std::vector<float> q((size_t)ch * n);
    for (size_t i = 0; i < q.size(); ++i)
        q[i] = cs[i % n] * (float)dct[i];
    pool_items((size_t)ch * tiles, nthreads, [&](size_t slot) {
        size_t c = slot / tiles;
        int i0 = (int)(slot % tiles) * kDctTile;
        int i1 = i0 + kDctTile < n ? i0 + kDctTile : n;
        dct_inv_tile(q.data() + c * n, out + c * n, cosines_t, n, quality,
                     ratio1, i0, i1);
    });
    return 0;
}

// FWHT of rows rows of n = 2^k int32 values, a row a pool item. Returns
// 0, or 1 unless n is a power of two.
int rpt_fwht(const int32_t* src, int32_t* dst, size_t rows, int n,
             int nthreads) {
    if (n < 1 || (n & (n - 1))) return 1;
    pool_items(rows, nthreads, [&](size_t r) {
        std::vector<int32_t> other((size_t)n);
        fwht_row(src + r * n, dst + r * n, other.data(), n);
    });
    return 0;
}

// The encode quantization a[i] = (int)(a[i] / (n / ratio)) (fwht.c:30-34)
// and the decode's a[i] = (int)(a[i] / ratio) (fwht.c:36-40), over count
// values.
void rpt_fwht_normalize(int32_t* a, size_t count, int n, double ratio) {
    double d = n / ratio;
    for (size_t i = 0; i < count; ++i) a[i] = x86_i32(a[i] / d);
}

void rpt_fwht_normalize2(int32_t* a, size_t count, double ratio) {
    for (size_t i = 0; i < count; ++i) a[i] = x86_i32(a[i] / ratio);
}

// --- the fused streaming span -----------------------------------------------

// A span of nframes blocks of ns interleaved bps-byte samples -> each
// block's xdelta_hzr container ([method 0][per plane: u32 length, hzr
// stream]), byte for byte what the streaming codec's unfused route gives:
// each channel through its serial f64 IIR (p coefficients, state xz / yz
// (ch, p) carried in and out; p == 0: no filter), each output converted
// as x86 does and stored as the low bps bytes of a sample (read back
// sign-extended), then per frame the xdelta planes with sequential
// verify-and-grow (the port's rule; a frame that grows the plane count
// grows it for every later frame) and every (frame, plane, 64 KiB block)
// encoded. With a filter one pool slot filters frame after frame while
// the others preprocess the filtered frames and encode the blocks of the
// frames that fit; frames from the first that does not fit are redone at
// the grown count after the pipeline ends. Frame f goes to out + f *
// frame_stride, its size to frame_lens[f], its plane count to
// frame_planes[f]. Returns the final plane count, or -1 on bad arguments
// or a frame that passes frame_stride.
int rpt_stream_filter_pack(const uint8_t* src, size_t ns, size_t nframes,
                           size_t ch, size_t bps, const double* nc,
                           const double* dc, int p, double* xz, double* yz,
                           int opt, int nr_planes_in, uint8_t* out,
                           size_t frame_stride, size_t* frame_lens,
                           int32_t* frame_planes, int nthreads) {
    if (ns == 0 || nframes == 0 || ch == 0 || bps < 1 || bps > 4 || p < 0 ||
        nr_planes_in < 1 || nr_planes_in > 4 || frame_stride < 1)
        return -1;
    nthreads = resolve_threads(nthreads);
    const size_t N = ns * nframes;  // samples a channel in the span
    const size_t F = ch * ns;       // flat values a frame
    const int vbits = 8 * (int)bps;
    if (F > 0xFFFFFFFFu) return -1;

    // with a filter: the span's samples as doubles, channel-major
    std::vector<double> xall(p > 0 ? ch * N : 0);
    if (p > 0)
        pool_ranges(N, (size_t)nthreads, [&](size_t t0, size_t t1) {
            for (size_t t = t0; t < t1; ++t)
                for (size_t j = 0; j < ch; ++j)
                    xall[j * N + t] =
                        (double)load_sample(src + (t * ch + j) * bps, bps);
        });
    // each frame's samples, channel-major: the filter's stored outputs,
    // or (no filter) the native samples, loaded by the preprocess
    std::vector<int32_t> sig(nframes * F);
    std::vector<uint8_t> planes(nframes * 4 * F);
    const size_t nb_per = (F + kMaxBlockSize - 1) / kMaxBlockSize;
    const size_t ipf = 4 * nb_per;  // item stride of a frame (4 planes)
    std::vector<uint32_t> hists(nframes * ipf * kNumSyms);
    const size_t bcap = (F < kMaxBlockSize ? F : kMaxBlockSize) +
                        kBlockHeaderSize + 16;
    std::vector<uint8_t> scratch(nframes * ipf * bcap);
    std::vector<size_t> blens(nframes * ipf, 0);

    // frame f's planes at npl and each block's histogram; its fit
    auto preprocess = [&](size_t f, int npl) -> bool {
        int32_t* v = sig.data() + f * F;
        if (p == 0)
            for (size_t c = 0; c < ch; ++c)
                for (size_t s = 0; s < ns; ++s)
                    v[c * ns + s] = load_sample(
                        src + ((f * ns + s) * ch + c) * bps, bps);
        uint8_t* pl = planes.data() + f * 4 * F;
        bool fits = xdelta_planes(v, 0, F, npl, (int)bps, pl, F);
        for (int k = 0; k < npl; ++k)
            for (size_t b = 0; b < nb_per; ++b) {
                size_t off = b * kMaxBlockSize;
                size_t blen = F - off < kMaxBlockSize ? F - off
                                                      : kMaxBlockSize;
                histogram_runs(pl + (size_t)k * F + off, blen,
                               hists.data() + (f * ipf + (size_t)k * nb_per +
                                               b) * kNumSyms);
            }
        return fits;
    };
    // item i: frame i / ipf, plane (i % ipf) / nb_per, block i % nb_per
    auto encode_item = [&](size_t i) {
        size_t f = i / ipf, k = (i % ipf) / nb_per, b = i % nb_per;
        size_t off = b * kMaxBlockSize;
        size_t blen = F - off < kMaxBlockSize ? F - off : kMaxBlockSize;
        blens[i] = encode_block_hist(planes.data() + f * 4 * F + k * F + off,
                                     blen, hists.data() + i * kNumSyms,
                                     scratch.data() + i * bcap, bcap);
    };

    // the pipeline: frames [0, filtered) are ready to preprocess; frame f's
    // state 2 if its planes fit, 3 if not; [0, settled) fit, so their
    // items may be encoded, item after item in order
    int np = nr_planes_in;
    std::unique_ptr<std::atomic<int>[]> state(new std::atomic<int>[nframes]);
    for (size_t f = 0; f < nframes; ++f) state[f].store(0);
    std::atomic<size_t> filtered(p > 0 ? 0 : nframes), next_pre(0),
        settled(0), next_enc(0), enc_done(0), pre_done(0);
    std::vector<double> ybuf(p > 0 ? F : 0);  // the filter's frame
    auto produce = [&]() {
        for (size_t f = 0; f < nframes; ++f) {
            for (size_t j0 = 0; j0 < ch; j0 += 4) {
                size_t nch = ch - j0 < 4 ? ch - j0 : 4;
                const double* xs4[4];
                double *xz4[4], *yz4[4], *ys4[4];
                for (size_t c = 0; c < nch; ++c) {
                    xs4[c] = xall.data() + (j0 + c) * N + f * ns;
                    xz4[c] = xz + (j0 + c) * (size_t)p;
                    yz4[c] = yz + (j0 + c) * (size_t)p;
                    ys4[c] = ybuf.data() + (j0 + c) * ns;
                }
                iir_channels4(xs4, nch, ns, nc, dc, p, xz4, yz4, opt, ys4);
            }
            int32_t* v = sig.data() + f * F;
            for (size_t i = 0; i < F; ++i)
                v[i] = sext((uint32_t)x86_i32(ybuf[i]), vbits);
            filtered.store(f + 1, std::memory_order_release);
        }
    };
    std::function<void(int)> worker = [&](int slot) {
        if (slot == 0 && p > 0) produce();
        for (;;) {
            size_t s = settled.load(std::memory_order_acquire);
            while (s < nframes &&
                   state[s].load(std::memory_order_acquire) == 2) {
                settled.compare_exchange_weak(s, s + 1);
                s = settled.load(std::memory_order_acquire);
            }
            // preprocess first: it unlocks encode work
            size_t f = next_pre.load(std::memory_order_relaxed);
            bool worked = false;
            while (f < nframes &&
                   f < filtered.load(std::memory_order_acquire)) {
                if (next_pre.compare_exchange_weak(f, f + 1)) {
                    bool fits = preprocess(f, np);
                    state[f].store(fits ? 2 : 3, std::memory_order_release);
                    pre_done.fetch_add(1, std::memory_order_acq_rel);
                    worked = true;
                    break;
                }
            }
            if (worked) continue;
            size_t e = next_enc.load(std::memory_order_relaxed);
            while (e < s * ipf) {
                if (next_enc.compare_exchange_weak(e, e + 1)) {
                    if ((e % ipf) < (size_t)np * nb_per) encode_item(e);
                    enc_done.fetch_add(1, std::memory_order_acq_rel);
                    worked = true;
                    break;
                }
            }
            if (worked) continue;
            if (pre_done.load(std::memory_order_acquire) == nframes) {
                size_t s2 = settled.load(std::memory_order_acquire);
                bool stalled = s2 >= nframes ||
                               state[s2].load(std::memory_order_acquire) == 3;
                if (stalled &&
                    enc_done.load(std::memory_order_acquire) >= s2 * ipf)
                    break;
            }
            std::this_thread::yield();
        }
    };
    ThreadPool::inst().run(nthreads, worker);

    // the verify-and-grow tail: from the first frame that did not fit, the
    // frames are preprocessed again one plane up, and those before the
    // next that does not fit are encoded at that count
    size_t f0 = settled.load();
    for (size_t f = 0; f < f0; ++f) frame_planes[f] = np;
    while (f0 < nframes) {
        if (++np > 4) return -1;  // 4 planes keep any sample
        std::vector<char> fit(nframes, 1);
        pool_items(nframes - f0, nthreads, [&](size_t i) {
            fit[f0 + i] = preprocess(f0 + i, np);
        });
        size_t fail = f0;
        while (fail < nframes && fit[fail]) ++fail;
        std::vector<size_t> items;
        for (size_t f = f0; f < fail; ++f) {
            frame_planes[f] = np;
            for (size_t j = 0; j < (size_t)np * nb_per; ++j)
                items.push_back(f * ipf + j);
        }
        pool_items(items.size(), nthreads,
                   [&](size_t q) { encode_item(items[q]); });
        f0 = fail;
    }

    for (size_t f = 0; f < nframes; ++f) {
        uint8_t* dst = out + f * frame_stride;
        size_t pos = 0;
        dst[pos++] = 0;  // method byte (signal_packer_hzr.cpp:54)
        for (int k = 0; k < frame_planes[f]; ++k) {
            size_t chunk = pos;
            if (pos + 8 > frame_stride) return -1;
            uint32_t total = (uint32_t)F;
            memcpy(dst + pos + 4, &total, 4);
            pos += 8;
            for (size_t b = 0; b < nb_per; ++b) {
                size_t i = f * ipf + (size_t)k * nb_per + b;
                if (!blens[i] || pos + blens[i] > frame_stride) return -1;
                memcpy(dst + pos, scratch.data() + i * bcap, blens[i]);
                pos += blens[i];
            }
            uint32_t clen = (uint32_t)(pos - chunk - 4);
            memcpy(dst + chunk, &clen, 4);
        }
        frame_lens[f] = pos;
    }
    return np;
}

}  // extern "C"
