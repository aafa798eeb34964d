// EGTP record codec: the native batch gather (a copy of
// emotiongestures_tpu/native/codec.cpp; the port builds and loads its own).
//
// Implements the wire format specified in ../data/codec.py (the
// authoritative spec) and provides the hot host-side batch gather the
// reference delegated to lmdb+pyarrow C/C++ (SURVEY.md §2.6): decode one
// named ndarray field from many records into a contiguous float32 buffer,
// multithreaded. Host C++, no CUDA: ../data/store.py builds it with g++ at
// first use into ../_build/ and binds it with ctypes.
#include <cstdint>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>

namespace {

constexpr uint8_t kKindNdarray = 0;
constexpr uint8_t kKindJson = 1;

struct Field {
  const uint8_t* data = nullptr;   // raw payload
  char dtype[8] = {0};             // e.g. "<f4"
  int64_t shape[8] = {0};
  int ndim = 0;
  int64_t count = 0;
};

inline uint16_t rd_u16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}
inline uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline int64_t rd_i64(const uint8_t* p) {
  int64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline int dtype_size(const char* d) {
  // "<f4" style: last char is the byte width
  return d[2] - '0';
}

inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while (!(mant & 0x400)) {
        mant <<= 1;
        --exp;
      }
      mant &= 0x3ff;
      bits = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7f800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

// Find a named ndarray field inside one record. Returns false on any
// parse error or if the field is missing / not an ndarray.
bool find_field(const uint8_t* buf, int64_t len, const char* name,
                Field* out) {
  if (len < 8 || std::memcmp(buf, "EGTP", 4) != 0) return false;
  uint16_t version = rd_u16(buf + 4);
  if (version != 1) return false;
  uint16_t n_fields = rd_u16(buf + 6);
  int64_t off = 8;
  size_t name_len_want = std::strlen(name);
  for (uint16_t i = 0; i < n_fields; ++i) {
    if (off + 1 > len) return false;
    uint8_t nl = buf[off++];
    if (off + nl + 1 > len) return false;
    const char* fname = reinterpret_cast<const char*>(buf + off);
    bool match = (nl == name_len_want) &&
                 std::memcmp(fname, name, nl) == 0;
    off += nl;
    uint8_t kind = buf[off++];
    if (kind == kKindNdarray) {
      if (off + 1 > len) return false;
      uint8_t dl = buf[off++];
      char dtype[8] = {0};
      if (dl >= 8 || off + dl > len) return false;
      std::memcpy(dtype, buf + off, dl);
      off += dl;
      if (off + 1 > len) return false;
      uint8_t ndim = buf[off++];
      if (ndim > 8 || off + 8 * ndim > len) return false;
      int64_t count = 1;
      int64_t shape[8];
      for (int d = 0; d < ndim; ++d) {
        shape[d] = rd_i64(buf + off);
        off += 8;
        count *= shape[d];
      }
      int64_t nbytes = count * dtype_size(dtype);
      if (off + nbytes > len) return false;
      if (match) {
        out->data = buf + off;
        std::memcpy(out->dtype, dtype, 8);
        out->ndim = ndim;
        std::memcpy(out->shape, shape, sizeof(shape));
        out->count = count;
        return true;
      }
      off += nbytes;
    } else if (kind == kKindJson) {
      if (off + 4 > len) return false;
      uint32_t jlen = rd_u32(buf + off);
      off += 4 + jlen;
      if (off > len) return false;
    } else {
      return false;
    }
  }
  return false;
}

bool convert_to_f32(const Field& f, float* out, int64_t expect_count) {
  if (f.count != expect_count) return false;
  const char t = f.dtype[1];
  const int sz = dtype_size(f.dtype);
  if (t == 'f' && sz == 4) {
    std::memcpy(out, f.data, f.count * 4);
  } else if (t == 'f' && sz == 2) {
    const uint16_t* src = reinterpret_cast<const uint16_t*>(f.data);
    for (int64_t i = 0; i < f.count; ++i) out[i] = half_to_float(src[i]);
  } else if (t == 'f' && sz == 8) {
    const double* src = reinterpret_cast<const double*>(f.data);
    for (int64_t i = 0; i < f.count; ++i) out[i] = (float)src[i];
  } else if (t == 'i' && sz == 8) {
    const int64_t* src = reinterpret_cast<const int64_t*>(f.data);
    for (int64_t i = 0; i < f.count; ++i) out[i] = (float)src[i];
  } else if (t == 'i' && sz == 4) {
    const int32_t* src = reinterpret_cast<const int32_t*>(f.data);
    for (int64_t i = 0; i < f.count; ++i) out[i] = (float)src[i];
  } else {
    return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Probe one record: writes ndim and shape of `name` in record `idx`.
// Returns 0 on success, negative on error.
int egtp_field_shape(const uint8_t* data, const int64_t* offsets,
                     int64_t idx, const char* name, int64_t* shape_out,
                     int* ndim_out) {
  const uint8_t* buf = data + offsets[idx];
  int64_t len = offsets[idx + 1] - offsets[idx];
  Field f;
  if (!find_field(buf, len, name, &f)) return -1;
  *ndim_out = f.ndim;
  for (int d = 0; d < f.ndim; ++d) shape_out[d] = f.shape[d];
  return 0;
}

// Decode field `name` of records `indices[0..n)` into `out`
// (n * elem_count float32, C-contiguous), multithreaded. When
// `shape`/`ndim` are given (shape non-null, ndim > 0) every record's
// full field shape must equal it — not just the element count — so a
// batch of records that all deviate identically from the canonical
// store layout still fails over to the exact python path.
// Returns 0 on success; -(i+1) if record indices[i] failed.
static int gather_impl(const uint8_t* data, const int64_t* offsets,
                       const int64_t* indices, int64_t n,
                       const char* name, float* out,
                       int64_t elem_count, const int64_t* shape, int ndim,
                       int n_threads) {
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > n) n_threads = (int)n;
  std::vector<std::thread> threads;
  std::vector<int64_t> errors(n_threads, -1);
  auto work = [&](int tid) {
    for (int64_t i = tid; i < n; i += n_threads) {
      int64_t idx = indices[i];
      const uint8_t* buf = data + offsets[idx];
      int64_t len = offsets[idx + 1] - offsets[idx];
      Field f;
      bool ok = find_field(buf, len, name, &f);
      if (ok && shape != nullptr && ndim > 0) {
        ok = (f.ndim == ndim);
        for (int d = 0; ok && d < ndim; ++d) ok = (f.shape[d] == shape[d]);
      }
      if (!ok || !convert_to_f32(f, out + i * elem_count, elem_count)) {
        errors[tid] = i;
        return;
      }
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
    for (auto& t : threads) t.join();
  }
  for (int t = 0; t < n_threads; ++t)
    if (errors[t] >= 0) return -(int)(errors[t] + 1);
  return 0;
}

int egtp_batch_gather_f32(const uint8_t* data, const int64_t* offsets,
                          const int64_t* indices, int64_t n,
                          const char* name, float* out,
                          int64_t elem_count, int n_threads) {
  return gather_impl(data, offsets, indices, n, name, out, elem_count,
                     nullptr, 0, n_threads);
}

int egtp_batch_gather_f32_shaped(const uint8_t* data,
                                 const int64_t* offsets,
                                 const int64_t* indices, int64_t n,
                                 const char* name, float* out,
                                 const int64_t* shape, int ndim,
                                 int n_threads) {
  int64_t elem_count = 1;
  for (int d = 0; d < ndim; ++d) elem_count *= shape[d];
  return gather_impl(data, offsets, indices, n, name, out, elem_count,
                     shape, ndim, n_threads);
}

}  // extern "C"
