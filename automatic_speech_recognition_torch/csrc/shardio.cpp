// Native ARSH shard reader: the data-path hot loop in C++.
//
// The reference relies on TFRecord's C++ reader inside tf.data
// (reference tfrecord_data_loader.py:33-39).  ARSH (data/shards.py) is this
// framework's container; this module memory-maps shards and assembles
// padded batch rows with single memcpys, replacing the Python per-record
// view + copy path when built.
//
// C ABI (consumed via ctypes in data/shards_native.py):
//   shard_open(path) -> handle (NULL on error)
//   shard_close(h)
//   shard_num_records(h), shard_feat_dim(h), shard_channels(h)
//   shard_featlen(h, i), shard_tokenlen(h, i)
//   shard_read_into(h, i, feat_dst, max_frames, tok_dst, max_tokens,
//                   &T, &L) -> 0/err   (clips to max_*, pads nothing:
//                   caller supplies zeroed buffers)

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

#pragma pack(push, 1)
struct Header {
  char magic[4];        // 'ARSH'
  uint32_t version;
  uint64_t num_records;
  uint32_t feat_dim;
  uint32_t channels;
  uint64_t index_offset;
};
#pragma pack(pop)

struct Shard {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  Header hdr{};
  const uint8_t* offsets = nullptr;  // raw index bytes (may be 4-aligned)
};

}  // namespace

extern "C" {

void* shard_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(Header)) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  // the whole file is read-mostly sequential-within-shard
  madvise(mem, st.st_size, MADV_WILLNEED);
  Shard* s = new Shard;
  s->fd = fd;
  s->base = (const uint8_t*)mem;
  s->size = st.st_size;
  memcpy(&s->hdr, s->base, sizeof(Header));
  // overflow-safe validation of untrusted header fields: compare with
  // subtraction against size, never with untrusted sums/products
  bool bad = memcmp(s->hdr.magic, "ARSH", 4) != 0
             || s->hdr.index_offset > s->size
             || s->hdr.num_records > (s->size - s->hdr.index_offset) / 8
             || (uint64_t)s->hdr.feat_dim * s->hdr.channels
                    > (uint64_t)1 << 24;
  if (bad) {
    munmap(mem, st.st_size);
    close(fd);
    delete s;
    return nullptr;
  }
  s->offsets = s->base + s->hdr.index_offset;
  return s;
}

void shard_close(void* h) {
  Shard* s = (Shard*)h;
  if (!s) return;
  munmap((void*)s->base, s->size);
  close(s->fd);
  delete s;
}

// null-handle guards: Python wrappers raise on a closed reader, but a
// NULL passed through ctypes must not dereference
int64_t shard_num_records(void* h) {
  return h ? (int64_t)((Shard*)h)->hdr.num_records : -1;
}
int32_t shard_feat_dim(void* h) { return h ? ((Shard*)h)->hdr.feat_dim : -1; }
int32_t shard_channels(void* h) { return h ? ((Shard*)h)->hdr.channels : -1; }

// The index can land on a 4-byte boundary (header 32 B + records of
// 8 + 4*words B), so a direct uint64_t* load would be misaligned UB on
// strict-alignment targets; memcpy is the portable load.
static inline uint64_t index_at(const Shard* s, int64_t i) {
  uint64_t off;
  memcpy(&off, s->offsets + 8 * i, 8);
  return off;
}

static inline const uint8_t* record_ptr(const Shard* s, int64_t i,
                                        uint32_t* T, uint32_t* L) {
  uint64_t off = index_at(s, i);
  if (off > s->size || s->size - off < 8) return nullptr;  // no overflow
  memcpy(T, s->base + off, 4);
  memcpy(L, s->base + off + 4, 4);
  return s->base + off + 8;
}

int32_t shard_featlen(void* h, int64_t i) {
  Shard* s = (Shard*)h;
  if (!s || i < 0 || (uint64_t)i >= s->hdr.num_records) return -1;
  uint32_t T, L;
  return record_ptr(s, i, &T, &L) ? (int32_t)T : -1;
}

int32_t shard_tokenlen(void* h, int64_t i) {
  Shard* s = (Shard*)h;
  if (!s || i < 0 || (uint64_t)i >= s->hdr.num_records) return -1;
  uint32_t T, L;
  return record_ptr(s, i, &T, &L) ? (int32_t)L : -1;
}

// Copy record i's features/tokens into caller buffers (clipped to
// max_frames / max_tokens).  Buffers must be pre-zeroed for padding.
int shard_read_into(void* h, int64_t i, float* feat_dst, int32_t max_frames,
                    int32_t* tok_dst, int32_t max_tokens,
                    int32_t* out_T, int32_t* out_L) {
  Shard* s = (Shard*)h;
  if (!s || i < 0 || (uint64_t)i >= s->hdr.num_records) return 1;
  uint32_t T, L;
  const uint8_t* p = record_ptr(s, i, &T, &L);
  if (!p) return 2;
  // overflow-safe: row <= 2^24 (validated at open), T/L are u32, so the
  // products fit u64; compare against the remaining bytes by subtraction
  uint64_t row = (uint64_t)s->hdr.feat_dim * s->hdr.channels;
  uint64_t feat_bytes = (uint64_t)T * row * 4;
  uint64_t avail = s->size - index_at(s, i) - 8;  // record_ptr checked >= 8
  if (feat_bytes > avail || (uint64_t)L * 4 > avail - feat_bytes) return 3;
  uint32_t copy_T = T < (uint32_t)max_frames ? T : (uint32_t)max_frames;
  uint32_t copy_L = L < (uint32_t)max_tokens ? L : (uint32_t)max_tokens;
  memcpy(feat_dst, p, (uint64_t)copy_T * row * 4);
  memcpy(tok_dst, p + feat_bytes, (uint64_t)copy_L * 4);
  *out_T = (int32_t)copy_T;
  *out_L = (int32_t)copy_L;
  return 0;
}

}  // extern "C"
