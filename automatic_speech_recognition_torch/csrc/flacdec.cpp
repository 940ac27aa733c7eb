// Native FLAC decoder for the ASR data path.
//
// The reference decodes FLAC through soundfile/libsndfile (reference
// preprocess.py:9, :69).  This framework carries its own dependency-free
// decoder: the full FLAC subset needed for speech corpora — constant /
// verbatim / fixed / LPC subframes, Rice(2) residuals with escape
// partitions, all channel assignments (independent, left/side, right/side,
// mid/side), 8..32-bit samples, any block size.  One documented limit:
// 32-bit streams using a stereo decorrelation mode need a 33-bit side
// channel (int64 sample path); those return decode error 7.  Speech
// corpora are 16/24-bit, and 32-bit FLAC itself only arrived with FLAC
// 1.4 — independent-channel 32-bit still decodes fine.
//
// Exposed as a tiny C ABI consumed via ctypes (data/flac.py):
//   flac_decode(data, size, &samples, &n, &rate, &channels, &bps) -> 0/err
//   flac_free(samples)
//
// Build: g++ -O2 -shared -fPIC -o libflacdec.so flacdec.cpp  (see Makefile)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;
  uint64_t bitbuf = 0;   // bits stored left-aligned consumption from MSB
  int bitcnt = 0;
  bool error = false;

  BitReader(const uint8_t* d, size_t s) : data(d), size(s) {}

  void fill() {
    while (bitcnt <= 56 && byte_pos < size) {
      bitbuf |= (uint64_t)data[byte_pos++] << (56 - bitcnt);
      bitcnt += 8;
    }
  }

  // read up to 32 bits, MSB first
  uint32_t read(int n) {
    if (n == 0) return 0;
    fill();
    if (bitcnt < n) { error = true; return 0; }
    uint32_t v = (uint32_t)(bitbuf >> (64 - n));
    bitbuf <<= n;
    bitcnt -= n;
    return v;
  }

  uint64_t read64(int n) {
    if (n <= 32) return read(n);
    uint64_t hi = read(n - 32);
    uint64_t lo = read(32);
    return (hi << 32) | lo;
  }

  int32_t read_signed(int n) {
    uint32_t v = read(n);
    if (n == 0 || n == 32) return (int32_t)v;
    // sign-extend
    uint32_t m = 1u << (n - 1);
    return (int32_t)((v ^ m) - m);
  }

  // count of leading zero bits then consume the terminating 1 (unary code)
  uint32_t read_unary() {
    uint32_t q = 0;
    for (;;) {
      fill();
      if (bitcnt == 0) { error = true; return 0; }
      if (bitbuf == 0) {            // all remaining buffered bits are zero
        q += bitcnt;
        bitbuf = 0;
        bitcnt = 0;
        continue;
      }
      int lz = __builtin_clzll(bitbuf);
      if (lz >= bitcnt) { q += bitcnt; bitbuf = 0; bitcnt = 0; continue; }
      q += lz;
      // consume zeros + the 1 bit; lz can be 63, and a << by 64 is UB
      bitbuf = (lz + 1 >= 64) ? 0 : (bitbuf << (lz + 1));
      bitcnt -= lz + 1;
      return q;
    }
  }

  void align_byte() {
    int drop = bitcnt % 8;
    bitbuf <<= drop;
    bitcnt -= drop;
  }

  bool at_end() {
    return bitcnt == 0 && byte_pos >= size;
  }
};

// UTF-8-style coded number used for frame/sample index (up to 36 bits)
uint64_t read_utf8(BitReader& br) {
  uint32_t b = br.read(8);
  if (b < 0x80) return b;
  int n = 0;
  uint32_t mask = 0x80;
  while (b & mask) { n++; mask >>= 1; }
  if (n < 2 || n > 7) { br.error = true; return 0; }
  uint64_t v = b & (0xFFu >> (n + 1));
  for (int i = 1; i < n; i++) {
    uint32_t c = br.read(8);
    if ((c & 0xC0) != 0x80) { br.error = true; return 0; }
    v = (v << 6) | (c & 0x3F);
  }
  return v;
}

const int kFixedOrders = 5;

// residual: Rice-coded partitions (method 0: 4-bit param, 1: 5-bit)
bool read_residual(BitReader& br, int blocksize, int pred_order,
                   int32_t* out /* blocksize-length, offset pred_order */) {
  int method = br.read(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  int porder = br.read(4);
  int partitions = 1 << porder;
  if (blocksize % partitions) return false;
  int psize = blocksize >> porder;
  if (psize <= pred_order && partitions == 1) return false;
  int idx = pred_order;
  for (int p = 0; p < partitions; p++) {
    int count = psize - (p == 0 ? pred_order : 0);
    if (count < 0) return false;
    uint32_t param = br.read(plen);
    if (param == escape) {
      int bits = br.read(5);
      for (int i = 0; i < count; i++) out[idx++] = br.read_signed(bits);
    } else {
      for (int i = 0; i < count; i++) {
        uint32_t q = br.read_unary();
        uint32_t lo = br.read(param);
        uint64_t u = ((uint64_t)q << param) | lo;
        out[idx++] = (int32_t)((u >> 1) ^ (~(u & 1) + 1));  // zigzag
      }
    }
    if (br.error) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int blocksize, int bps,
                     std::vector<int32_t>& out) {
  out.resize(blocksize);
  if (br.read(1) != 0) return false;  // padding bit
  int type = br.read(6);
  int wasted = 0;
  if (br.read(1)) {                   // wasted bits: unary count - 1
    wasted = 1 + br.read_unary();
    bps -= wasted;
  }
  if (bps <= 0 || bps > 32) return false;

  if (type == 0) {                    // CONSTANT
    int32_t v = br.read_signed(bps);
    for (int i = 0; i < blocksize; i++) out[i] = v;
  } else if (type == 1) {             // VERBATIM
    for (int i = 0; i < blocksize; i++) out[i] = br.read_signed(bps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) < kFixedOrders) {
    int order = type & 0x07;          // FIXED
    if (order > blocksize) return false;  // warm-up must fit the block
    for (int i = 0; i < order; i++) out[i] = br.read_signed(bps);
    if (!read_residual(br, blocksize, order, out.data())) return false;
    switch (order) {
      case 0: break;
      case 1:
        for (int i = 1; i < blocksize; i++) out[i] += out[i - 1];
        break;
      case 2:
        for (int i = 2; i < blocksize; i++)
          out[i] += 2 * out[i - 1] - out[i - 2];
        break;
      case 3:
        for (int i = 3; i < blocksize; i++)
          out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
        break;
      case 4:
        for (int i = 4; i < blocksize; i++)
          out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3]
                    - out[i - 4];
        break;
    }
  } else if (type & 0x20) {           // LPC, order = (type & 0x1F) + 1
    int order = (type & 0x1F) + 1;
    if (order > blocksize) return false;  // warm-up must fit the block
    for (int i = 0; i < order; i++) out[i] = br.read_signed(bps);
    int precision = br.read(4);
    if (precision == 0xF) return false;
    precision += 1;
    int shift = br.read_signed(5);
    if (shift < 0) return false;
    int32_t coef[32];
    for (int i = 0; i < order; i++) coef[i] = br.read_signed(precision);
    if (!read_residual(br, blocksize, order, out.data())) return false;
    for (int i = order; i < blocksize; i++) {
      int64_t acc = 0;
      for (int j = 0; j < order; j++)
        acc += (int64_t)coef[j] * out[i - 1 - j];
      out[i] += (int32_t)(acc >> shift);
    }
  } else {
    return false;
  }
  if (wasted)
    for (int i = 0; i < blocksize; i++)
      out[i] = (int32_t)((uint32_t)out[i] << wasted);
  return !br.error;
}

const int kBlockSizeTable[16] = {0, 192, 576, 1152, 2304, 4608, -1, -2,
                                 256, 512, 1024, 2048, 4096, 8192, 16384,
                                 32768};

}  // namespace

extern "C" {

// Returns 0 on success.  Caller frees *out_samples with flac_free.
// Samples are interleaved int32 (original bit depth, not shifted).
int flac_decode(const uint8_t* data, size_t size, int32_t** out_samples,
                int64_t* out_n /* per channel */, int* out_rate,
                int* out_channels, int* out_bps) {
  // never let a C++ exception (e.g. bad_alloc from a corrupt header)
  // unwind through the ctypes FFI boundary
  try {
  if (size < 42 || memcmp(data, "fLaC", 4) != 0) return 1;
  size_t pos = 4;
  int sample_rate = 0, channels = 0, bps = 0;
  uint64_t total_samples = 0;
  bool have_streaminfo = false;

  // metadata blocks
  for (;;) {
    if (pos + 4 > size) return 2;
    int last = data[pos] >> 7;
    int type = data[pos] & 0x7F;
    uint32_t len = (data[pos + 1] << 16) | (data[pos + 2] << 8)
                   | data[pos + 3];
    pos += 4;
    if (pos + len > size) return 2;
    if (type == 0 && len >= 34) {       // STREAMINFO
      const uint8_t* p = data + pos;
      sample_rate = (p[10] << 12) | (p[11] << 4) | (p[12] >> 4);
      channels = ((p[12] >> 1) & 0x7) + 1;
      bps = (((p[12] & 1) << 4) | (p[13] >> 4)) + 1;
      total_samples = ((uint64_t)(p[13] & 0xF) << 32) | ((uint64_t)p[14] << 24)
                      | (p[15] << 16) | (p[16] << 8) | p[17];
      have_streaminfo = true;
    }
    pos += len;
    if (last) break;
  }
  if (!have_streaminfo || sample_rate == 0 || channels < 1 || channels > 8)
    return 3;

  std::vector<int32_t> pcm;
  // reserve from the untrusted header only up to a sane cap; push_back
  // grows beyond it if the data is really there
  if (total_samples) {
    uint64_t want = total_samples * (uint64_t)channels;
    uint64_t cap = size * 4ull;  // decoded PCM can't dwarf the file 16x
    pcm.reserve((size_t)(want < cap ? want : cap));
  }

  BitReader br(data + pos, size - pos);
  std::vector<std::vector<int32_t>> ch(channels);
  bool decode_error = false;

  while (!br.at_end()) {
    br.align_byte();
    // scan to the next frame sync (tolerates trailing garbage/ID3 absence)
    uint32_t sync = br.read(14);
    bool found = sync == 0x3FFE;
    while (!found && !br.error && !br.at_end()) {
      // slide one byte at a time
      sync = ((sync << 8) & 0x3FFF) | br.read(8);
      found = sync == 0x3FFE;
    }
    if (!found || br.error) break;

    br.read(1);                          // reserved
    br.read(1);                          // blocking strategy
    int bs_code = br.read(4);
    int sr_code = br.read(4);
    int ch_assign = br.read(4);
    int ss_code = br.read(3);
    br.read(1);                          // reserved
    read_utf8(br);                       // frame/sample number

    int blocksize;
    if (bs_code == 0) { decode_error = true; break; }  // reserved
    blocksize = kBlockSizeTable[bs_code];
    if (blocksize == -1) blocksize = br.read(8) + 1;
    else if (blocksize == -2) blocksize = br.read(16) + 1;

    if (sr_code == 12) br.read(8);
    else if (sr_code == 13 || sr_code == 14) br.read(16);

    static const int ss_table[8] = {0, 8, 12, 0, 16, 20, 24, 32};
    int frame_bps = ss_table[ss_code];
    if (frame_bps == 0) frame_bps = bps;

    br.read(8);                          // CRC-8

    int nch = channels;
    bool left_side = false, right_side = false, mid_side = false;
    if (ch_assign <= 7) {
      nch = ch_assign + 1;
      if (nch != channels) { decode_error = true; break; }
    } else if (ch_assign >= 8 && ch_assign <= 10) {
      // stereo decorrelation modes are only valid for 2-channel streams
      if (channels != 2) { decode_error = true; break; }
      left_side = ch_assign == 8;
      right_side = ch_assign == 9;
      mid_side = ch_assign == 10;
      nch = 2;
    } else { decode_error = true; break; }

    bool ok = true;
    for (int c = 0; c < nch && ok; c++) {
      int sub_bps = frame_bps;
      if ((left_side && c == 1) || (right_side && c == 0)
          || (mid_side && c == 1))
        sub_bps += 1;                    // side channel carries 1 extra bit
      // sub_bps 33 (32-bit stream + decorrelation) would need 64-bit
      // sample reads; decode_subframe's bps > 32 guard rejects it — see
      // the header comment for this documented limitation
      ok = decode_subframe(br, blocksize, sub_bps, ch[c]);
    }
    if (!ok || br.error) { decode_error = true; break; }

    br.align_byte();
    br.read(16);                         // CRC-16

    // undo inter-channel decorrelation
    if (left_side) {
      for (int i = 0; i < blocksize; i++) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (right_side) {
      for (int i = 0; i < blocksize; i++) ch[0][i] = ch[1][i] + ch[0][i];
    } else if (mid_side) {
      for (int i = 0; i < blocksize; i++) {
        int32_t side = ch[1][i];
        int32_t mid = (ch[0][i] << 1) | (side & 1);
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    }

    for (int i = 0; i < blocksize; i++)
      for (int c = 0; c < channels; c++)
        pcm.push_back(ch[c][i]);

    if (total_samples && pcm.size() >= total_samples * channels) break;
  }

  if (pcm.empty()) return 4;
  // a frame failed mid-stream and the header-declared length was not
  // reached: report the corruption instead of silently truncating
  if (decode_error && total_samples
      && pcm.size() < total_samples * (uint64_t)channels)
    return 7;
  int64_t n = (int64_t)(pcm.size() / channels);
  if (total_samples && (uint64_t)n > total_samples)
    n = (int64_t)total_samples;        // drop padding from final block
  int32_t* buf = (int32_t*)malloc(sizeof(int32_t) * n * channels);
  if (!buf) return 5;
  memcpy(buf, pcm.data(), sizeof(int32_t) * n * channels);
  *out_samples = buf;
  *out_n = n;
  *out_rate = sample_rate;
  *out_channels = channels;
  *out_bps = bps;
  return 0;
  } catch (...) {
    return 6;
  }
}

void flac_free(int32_t* p) { free(p); }

}  // extern "C"
