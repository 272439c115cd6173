// Host-side rANS entropy coder for nic_tpu_torch: a copy of
// nic_tpu/coding/rans.cpp (the port may not load the JAX package's library),
// built by nic_tpu_torch/ops/build.py with g++ into _build/librans.so.
//
// It stands in for the C++ range-coder kernels the reference pulls in
// through tensorflow-compression (RangeEncode/RangeDecode, used via
// entropy_bottleneck.compress / conditional_bottleneck.compress, the
// reference's mbt2018.py:84-85, 269-280). Written from scratch:
// a byte-renormalized rANS with per-symbol CDF-row indexing and an
// escape-symbol + bypass path for out-of-range values, so any integer
// latent round-trips losslessly regardless of the modeled support.
//
// Conventions:
//   - Each CDF row r has cdf_sizes[r] symbol slots; the row stores
//     cdf_sizes[r] + 1 cumulative values with cdf[0] == 0 and
//     cdf[size] == 1 << precision. Every slot must have nonzero frequency.
//   - The LAST slot of each row (index size-1) is the escape symbol.
//     In-range symbols are 0 .. size-2. Out-of-range symbols are coded as
//     escape followed by a zigzagged overflow value in 4-bit bypass chunks
//     (3 payload bits + 1 continuation bit per chunk).
//   - rANS is LIFO: symbols are encoded in reverse and the byte stream is
//     emitted so the decoder reads forward.
//
// Build: g++ -O3 -shared -fPIC rans.cpp -o librans.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kRansL = 1u << 23;  // lower bound of the state interval

struct Op {
  uint32_t start;
  uint32_t freq;
};

inline uint32_t zigzag(int64_t v) {
  // 0,-1,1,-2,2,... -> 0,1,2,3,4,...
  return static_cast<uint32_t>((v << 1) ^ (v >> 63));
}

inline int64_t unzigzag(uint32_t z) {
  return static_cast<int64_t>(z >> 1) ^ -static_cast<int64_t>(z & 1);
}

// --------------------------------------------------- decode bucket index
//
// Decode spends most of its time binary-searching the CDF row for the slot
// (the encoder indexes directly). When rows are reused many times (the
// mbt2018 tables: 64 scale rows for y, one row per channel for z, ~1.2k
// symbols/row on a Kodak-sized image), a per-row coarse index — for each
// 2^(precision-8)-wide slot bucket, the symbol bracket it can fall in —
// shrinks the search to a couple of entries. Rows used ~once (the
// bits-back per-element posterior tables) skip it: building would cost
// more than it saves; see the n >= 4*rows gate at the call sites.

constexpr int32_t kBucketBits = 8;  // 2^8 buckets per row

struct BucketIndex {
  std::vector<int32_t> lo;  // (rows, n_buckets + 1): symbol bracket starts
  int32_t n_buckets = 0;
  int32_t shift = 0;

  // Rows with invalid CDFs get lo[0] = -1 (decode falls back to a full
  // binary search and then reports the error as before).
  void build(const uint32_t* cdfs, int64_t stride, const int32_t* cdf_sizes,
             int32_t rows, int32_t precision) {
    shift = precision > kBucketBits ? precision - kBucketBits : 0;
    n_buckets = 1 << (precision - shift);
    const uint32_t prec_total = 1u << precision;
    lo.assign(static_cast<size_t>(rows) * (n_buckets + 1), 0);
    for (int32_t r = 0; r < rows; ++r) {
      int32_t* bl = lo.data() + static_cast<size_t>(r) * (n_buckets + 1);
      const uint32_t* cdf = cdfs + r * stride;
      const int32_t size = cdf_sizes[r];
      if (size < 2 || cdf[size] != prec_total) {
        bl[0] = -1;
        continue;
      }
      int32_t s = 0;
      for (int32_t b = 0; b <= n_buckets; ++b) {
        const uint32_t target = static_cast<uint32_t>(b) << shift;
        while (s + 1 < size && cdf[s + 1] <= target) ++s;
        bl[b] = s;
      }
    }
  }

  // Bracket [lo, hi) for a slot in row r; assumes a valid built row.
  inline void bracket(int32_t r, uint32_t slot, int32_t* out_lo,
                      int32_t* out_hi) const {
    const int32_t* bl = lo.data() + static_cast<size_t>(r) * (n_buckets + 1);
    const uint32_t b = slot >> shift;
    *out_lo = bl[b];
    *out_hi = bl[b + 1] + 1;
  }

  inline bool row_ok(int32_t r) const {
    return lo[static_cast<size_t>(r) * (n_buckets + 1)] >= 0;
  }
};

inline int32_t max_row(const int32_t* indexes, int64_t n) {
  int32_t m = -1;
  for (int64_t i = 0; i < n; ++i) m = std::max(m, indexes[i]);
  return m;
}

}  // namespace

extern "C" {

// Encodes n symbols. Returns number of bytes written, or -1 if `capacity`
// is too small, -2 on invalid inputs.
int64_t rans_encode(const int32_t* symbols, const int32_t* indexes, int64_t n,
                    const uint32_t* cdfs, int64_t stride,
                    const int32_t* cdf_sizes, int32_t precision, uint8_t* out,
                    int64_t capacity) {
  if (precision < 8 || precision > 16) return -2;
  const uint32_t prec_total = 1u << precision;

  // Build the forward op list (symbol ops + bypass chunk ops), then encode
  // it in reverse (rANS is LIFO).
  std::vector<Op> ops;
  ops.reserve(static_cast<size_t>(n) + 16);
  const uint32_t bypass_freq = prec_total >> 4;  // 4-bit uniform chunks

  for (int64_t i = 0; i < n; ++i) {
    const int32_t row = indexes[i];
    const uint32_t* cdf = cdfs + row * stride;
    const int32_t size = cdf_sizes[row];
    if (size < 2 || cdf[size] != prec_total) return -2;
    int64_t s = symbols[i];
    uint32_t overflow = 0;
    bool escaped = false;
    if (s < 0) {
      overflow = zigzag(s);  // negative -> odd codes
      escaped = true;
    } else if (s >= size - 1) {
      overflow = zigzag(s - (size - 1));  // 0, 2, 4, ... even codes? no:
      // zigzag(nonneg k) = 2k (even codes); negatives got odd. Bijective.
      escaped = true;
    }
    const int32_t slot = escaped ? size - 1 : static_cast<int32_t>(s);
    ops.push_back({cdf[slot], cdf[slot + 1] - cdf[slot]});
    if (escaped) {
      // Emit 4-bit chunks little-endian (low chunk first in decode order).
      uint32_t z = overflow;
      while (true) {
        uint32_t chunk = z & 7u;
        z >>= 3;
        if (z != 0) chunk |= 8u;  // continuation bit
        ops.push_back({chunk * bypass_freq, bypass_freq});
        if (z == 0) break;
      }
    }
  }

  // Reverse-encode into a byte buffer (emitted back-to-front).
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(n) * 2 + 32);
  uint32_t state = kRansL;
  for (size_t k = ops.size(); k-- > 0;) {
    const Op& op = ops[k];
    // Renormalize: keep state < ((L >> precision) << 8) * freq.
    const uint32_t x_max = ((kRansL >> precision) << 8) * op.freq;
    while (state >= x_max) {
      buf.push_back(static_cast<uint8_t>(state & 0xffu));
      state >>= 8;
    }
    state = ((state / op.freq) << precision) + (state % op.freq) + op.start;
  }
  // Flush the 32-bit state (little-endian in reversed buffer).
  for (int b = 3; b >= 0; --b)
    buf.push_back(static_cast<uint8_t>((state >> (8 * (3 - b))) & 0xffu));

  const int64_t total = static_cast<int64_t>(buf.size());
  if (total > capacity) return -1;
  // The buffer was built back-to-front; reverse so decode reads forward.
  for (int64_t i = 0; i < total; ++i) out[i] = buf[total - 1 - i];
  return total;
}

}  // extern "C"

namespace {

// Decodes n symbols; returns n on success, negative on error. `bi` (may be
// null) narrows the per-symbol CDF search to a bucket bracket.
int64_t decode_impl(const uint8_t* bytes, int64_t nbytes,
                    const int32_t* indexes, int64_t n, const uint32_t* cdfs,
                    int64_t stride, const int32_t* cdf_sizes,
                    int32_t precision, int32_t* out_symbols,
                    const BucketIndex* bi) {
  if (precision < 8 || precision > 16) return -2;
  if (nbytes < 4) return -3;
  const uint32_t prec_total = 1u << precision;
  const uint32_t mask = prec_total - 1;
  const uint32_t bypass_bits = precision - 4;

  int64_t pos = 0;
  uint32_t state = 0;
  for (int b = 0; b < 4; ++b) state = (state << 8) | bytes[pos++];

  auto pull = [&](uint32_t freq, uint32_t start, uint32_t slot) {
    state = freq * (state >> precision) + slot - start;
    while (state < kRansL) {
      if (pos >= nbytes) {
        // Stream exhausted: pad with zeros (matches encoder flush).
        state <<= 8;
      } else {
        state = (state << 8) | bytes[pos++];
      }
    }
  };

  for (int64_t i = 0; i < n; ++i) {
    const int32_t row = indexes[i];
    const uint32_t* cdf = cdfs + row * stride;
    const int32_t size = cdf_sizes[row];
    if (size < 2 || cdf[size] != prec_total) return -2;

    const uint32_t slot = state & mask;
    // Find s with cdf[s] <= slot < cdf[s+1]: binary search, narrowed to
    // the bucket bracket when the index is available.
    int32_t lo = 0, hi = size;
    if (bi && bi->row_ok(row)) bi->bracket(row, slot, &lo, &hi);
    while (hi - lo > 1) {
      const int32_t mid = (lo + hi) >> 1;
      if (cdf[mid] <= slot) lo = mid;
      else hi = mid;
    }
    const int32_t s = lo;
    pull(cdf[s + 1] - cdf[s], cdf[s], slot);

    if (s == size - 1) {
      // Escape: read zigzagged overflow in 4-bit chunks.
      uint32_t z = 0;
      int shift = 0;
      while (true) {
        const uint32_t chunk_slot = state & mask;
        const uint32_t chunk = chunk_slot >> bypass_bits;
        pull(prec_total >> 4, chunk << bypass_bits, chunk_slot);
        z |= (chunk & 7u) << shift;
        shift += 3;
        if (!(chunk & 8u)) break;
        if (shift > 60) return -4;
      }
      const int64_t v = unzigzag(z);
      // Negative v <=> odd zigzag code <=> the symbol was below the range;
      // nonnegative v was an overflow of (size-1) or more above it.
      out_symbols[i] = v < 0 ? static_cast<int32_t>(v)
                             : static_cast<int32_t>(v + (size - 1));
    } else {
      out_symbols[i] = s;
    }
  }
  return n;
}

// Build the bucket index only when rows are reused enough to amortize it
// (~size+256 ops/row to build vs ~10 saved ops/use; 4 uses/row is already
// past break-even). The bits-back per-element tables (one row per symbol)
// stay on the plain binary search.
inline bool want_bucket_index(int64_t n, int32_t rows) {
  return rows > 0 && n >= 4 * static_cast<int64_t>(rows);
}

}  // namespace

extern "C" {

int64_t rans_decode(const uint8_t* bytes, int64_t nbytes,
                    const int32_t* indexes, int64_t n, const uint32_t* cdfs,
                    int64_t stride, const int32_t* cdf_sizes,
                    int32_t precision, int32_t* out_symbols) {
  if (precision < 8 || precision > 16) return -2;
  const int32_t rows = max_row(indexes, n) + 1;
  if (want_bucket_index(n, rows)) {
    BucketIndex bi;
    bi.build(cdfs, stride, cdf_sizes, rows, precision);
    return decode_impl(bytes, nbytes, indexes, n, cdfs, stride, cdf_sizes,
                       precision, out_symbols, &bi);
  }
  return decode_impl(bytes, nbytes, indexes, n, cdfs, stride, cdf_sizes,
                     precision, out_symbols, nullptr);
}

}  // extern "C"

// ------------------------------------------------------------- rANS stack
//
// Stateful LIFO coder for bits-back (BB-ANS) style interleaved
// encode/decode on ONE stream: `decode` pops symbols (consuming bits from
// the top of the stack), `encode` pushes them. The reference never
// implements this — its bits-back rates are ELBO estimates only
// (SURVEY.md section 3.4).
//
// State layout: 32-bit rANS state + byte stack (top = end of vector).
// Serialization: [4-byte little-endian state][stack bytes bottom..top].

struct RansStack {
  uint32_t state;
  std::vector<uint8_t> bytes;
};

extern "C" {

void* rans_stack_create(const uint8_t* init, int64_t n) {
  auto* s = new RansStack();
  s->state = kRansL;
  if (init && n > 0) s->bytes.assign(init, init + n);
  return s;
}

void rans_stack_destroy(void* handle) {
  delete static_cast<RansStack*>(handle);
}

int64_t rans_stack_size(void* handle) {
  auto* s = static_cast<RansStack*>(handle);
  return 4 + static_cast<int64_t>(s->bytes.size());
}

int64_t rans_stack_serialize(void* handle, uint8_t* out, int64_t capacity) {
  auto* s = static_cast<RansStack*>(handle);
  const int64_t total = 4 + static_cast<int64_t>(s->bytes.size());
  if (total > capacity) return -1;
  for (int b = 0; b < 4; ++b)
    out[b] = static_cast<uint8_t>((s->state >> (8 * b)) & 0xffu);
  std::memcpy(out + 4, s->bytes.data(), s->bytes.size());
  return total;
}

void* rans_stack_deserialize(const uint8_t* data, int64_t n) {
  if (n < 4) return nullptr;
  auto* s = new RansStack();
  s->state = 0;
  for (int b = 0; b < 4; ++b)
    s->state |= static_cast<uint32_t>(data[b]) << (8 * b);
  s->bytes.assign(data + 4, data + n);
  return s;
}

// Pushes n symbols (FIFO argument order; symbols[0] is pushed first and
// therefore popped LAST by the matching decode). Per-symbol CDF rows via
// `indexes`. Escape/bypass is NOT supported on the stack API: symbols must
// lie in [0, cdf_sizes[row]-1]. Returns 0 or a negative error.
int64_t rans_stack_encode(void* handle, const int32_t* symbols,
                          const int32_t* indexes, int64_t n,
                          const uint32_t* cdfs, int64_t stride,
                          const int32_t* cdf_sizes, int32_t precision) {
  if (precision < 8 || precision > 16) return -2;
  auto* s = static_cast<RansStack*>(handle);
  const uint32_t prec_total = 1u << precision;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t row = indexes[i];
    const uint32_t* cdf = cdfs + row * stride;
    const int32_t size = cdf_sizes[row];
    const int64_t sym = symbols[i];
    if (sym < 0 || sym >= size) return -6;
    if (cdf[size] != prec_total) return -2;
    const uint32_t start = cdf[sym];
    const uint32_t freq = cdf[sym + 1] - start;
    const uint32_t x_max = ((kRansL >> precision) << 8) * freq;
    while (s->state >= x_max) {
      s->bytes.push_back(static_cast<uint8_t>(s->state & 0xffu));
      s->state >>= 8;
    }
    s->state = ((s->state / freq) << precision) + (s->state % freq) + start;
  }
  return 0;
}

// Pops n symbols; out[0] is the first popped. Exactly inverts a matching
// rans_stack_encode with the arguments reversed. When the stack underflows
// (fresh/initial-bits exhausted), zero bytes are synthesized — callers that
// need exact bit recovery must provide enough initial bits.
int64_t rans_stack_decode(void* handle, const int32_t* indexes, int64_t n,
                          const uint32_t* cdfs, int64_t stride,
                          const int32_t* cdf_sizes, int32_t precision,
                          int32_t* out_symbols) {
  if (precision < 8 || precision > 16) return -2;
  auto* s = static_cast<RansStack*>(handle);
  const uint32_t prec_total = 1u << precision;
  const uint32_t mask = prec_total - 1;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t row = indexes[i];
    const uint32_t* cdf = cdfs + row * stride;
    const int32_t size = cdf_sizes[row];
    if (cdf[size] != prec_total) return -2;
    const uint32_t slot = s->state & mask;
    int32_t lo = 0, hi = size;
    while (hi - lo > 1) {
      const int32_t mid = (lo + hi) >> 1;
      if (cdf[mid] <= slot) lo = mid;
      else hi = mid;
    }
    out_symbols[i] = lo;
    const uint32_t freq = cdf[lo + 1] - cdf[lo];
    s->state = freq * (s->state >> precision) + slot - cdf[lo];
    while (s->state < kRansL) {
      uint8_t byte = 0;
      if (!s->bytes.empty()) {
        byte = s->bytes.back();
        s->bytes.pop_back();
      }
      s->state = (s->state << 8) | byte;
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------- batching
//
// One independent rANS stream per item (image), encoded/decoded across a
// thread pool. Streams are independent so decode can also parallelize —
// this is the host-side throughput path for production serving, where the
// device forward is fast and entropy coding would otherwise serialize.

extern "C" {

int64_t rans_encode_batch(const int32_t* symbols, const int32_t* indexes,
                          int64_t n_per_item, int32_t n_items,
                          const uint32_t* cdfs, int64_t stride,
                          const int32_t* cdf_sizes, int32_t precision,
                          uint8_t* out, int64_t capacity_per_item,
                          int64_t* out_sizes, int32_t n_threads);

int64_t rans_decode_batch(const uint8_t* bytes, const int64_t* offsets,
                          const int64_t* sizes, int32_t n_items,
                          const int32_t* indexes, int64_t n_per_item,
                          const uint32_t* cdfs, int64_t stride,
                          const int32_t* cdf_sizes, int32_t precision,
                          int32_t* out_symbols, int32_t n_threads);

}  // extern "C"

#include <atomic>
#include <thread>

namespace {

template <typename Fn>
void parallel_for_items(int32_t n_items, int32_t n_threads, Fn&& fn) {
  if (n_threads <= 1 || n_items <= 1) {
    for (int32_t i = 0; i < n_items; ++i) fn(i);
    return;
  }
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    while (true) {
      const int32_t i = next.fetch_add(1);
      if (i >= n_items) break;
      fn(i);
    }
  };
  const int32_t k =
      std::min<int32_t>(n_threads, n_items);
  std::vector<std::thread> threads;
  threads.reserve(k);
  for (int32_t t = 0; t < k; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

int64_t rans_encode_batch(const int32_t* symbols, const int32_t* indexes,
                          int64_t n_per_item, int32_t n_items,
                          const uint32_t* cdfs, int64_t stride,
                          const int32_t* cdf_sizes, int32_t precision,
                          uint8_t* out, int64_t capacity_per_item,
                          int64_t* out_sizes, int32_t n_threads) {
  std::atomic<int64_t> status(0);
  parallel_for_items(n_items, n_threads, [&](int32_t i) {
    const int64_t r = rans_encode(
        symbols + i * n_per_item, indexes + i * n_per_item, n_per_item, cdfs,
        stride, cdf_sizes, precision, out + i * capacity_per_item,
        capacity_per_item);
    out_sizes[i] = r;
    if (r < 0) status.store(r);
  });
  return status.load();
}

int64_t rans_decode_batch(const uint8_t* bytes, const int64_t* offsets,
                          const int64_t* sizes, int32_t n_items,
                          const int32_t* indexes, int64_t n_per_item,
                          const uint32_t* cdfs, int64_t stride,
                          const int32_t* cdf_sizes, int32_t precision,
                          int32_t* out_symbols, int32_t n_threads) {
  if (precision < 8 || precision > 16) return -2;
  // One shared bucket index across all items (read-only during decode).
  const int32_t rows =
      max_row(indexes, n_per_item * static_cast<int64_t>(n_items)) + 1;
  BucketIndex bi;
  const bool use_bi =
      want_bucket_index(n_per_item * static_cast<int64_t>(n_items), rows);
  if (use_bi) bi.build(cdfs, stride, cdf_sizes, rows, precision);
  std::atomic<int64_t> status(0);
  parallel_for_items(n_items, n_threads, [&](int32_t i) {
    const int64_t r = decode_impl(
        bytes + offsets[i], sizes[i], indexes + i * n_per_item, n_per_item,
        cdfs, stride, cdf_sizes, precision, out_symbols + i * n_per_item,
        use_bi ? &bi : nullptr);
    if (r != n_per_item) status.store(r < 0 ? r : -5);
  });
  return status.load();
}

}  // extern "C"
