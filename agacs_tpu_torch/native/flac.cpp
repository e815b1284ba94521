// FLAC stream codec (decode + fixed-predictor encode), C ABI for ctypes.
//
// The host-side replacement for the reference's libsndfile/soundfile FLAC
// path (espnet2/fileio/sound_scp.py; dump format `flac.ark` written by
// egs2/TEMPLATE/asr1/pyscripts/audio/format_wav_scp.py:152-160). The
// image ships no FLAC library, so the format (RFC 9639) is implemented
// here: metadata parsing, frame headers, constant/verbatim/fixed/LPC
// subframes, rice-coded residual partitions, stereo decorrelation.
//
// MD5 of the raw PCM (STREAMINFO bytes 18..34) is returned to the caller
// rather than computed here — Python verifies it with hashlib.
//
// Built on first use by agacs_tpu_torch/data/flac.py:
//   g++ -O3 -shared -fPIC -o build/agacs_tpu_torch/flac-<hash>.so flac.cpp

#include <cstdint>
#include <cstring>

namespace {

// ----------------------------------------------------------------- bit IO

struct BitReader {
  const uint8_t* data;
  long long len;       // bytes
  long long pos;       // bit position
  bool overflow;

  BitReader(const uint8_t* d, long long n) : data(d), len(n), pos(0), overflow(false) {}

  inline uint32_t bit() {
    if (pos >= len * 8) { overflow = true; return 0; }
    uint32_t b = (data[pos >> 3] >> (7 - (pos & 7))) & 1u;
    pos++;
    return b;
  }

  // n <= 32
  inline uint64_t bits(int n) {
    uint64_t v = 0;
    if (pos + n > len * 8) { overflow = true; pos = len * 8; return 0; }
    // fast path: byte-aligned whole bytes
    while (n >= 8 && (pos & 7) == 0) {
      v = (v << 8) | data[pos >> 3];
      pos += 8;
      n -= 8;
    }
    while (n > 0) {
      v = (v << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1u);
      pos++;
      n--;
    }
    return v;
  }

  inline int64_t sbits(int n) {  // signed, two's complement
    uint64_t v = bits(n);
    if (n > 0 && (v >> (n - 1)) & 1u) v |= ~((1ull << n) - 1);
    return (int64_t)v;
  }

  inline uint32_t unary() {  // count 0s until a 1
    uint32_t q = 0;
    while (!overflow && bit() == 0) q++;
    return q;
  }

  inline void align_byte() { pos = (pos + 7) & ~7ll; }
  inline long long byte_pos() const { return pos >> 3; }
};

struct BitWriter {
  uint8_t* out;
  long long cap;   // bytes
  long long pos;   // bit position
  bool overflow;

  BitWriter(uint8_t* o, long long c) : out(o), cap(c), pos(0), overflow(false) {
    if (cap > 0) memset(out, 0, (size_t)cap);
  }

  inline void bits(uint64_t v, int n) {
    if (pos + n > cap * 8) { overflow = true; return; }
    for (int i = n - 1; i >= 0; i--) {
      if ((v >> i) & 1ull) out[pos >> 3] |= (uint8_t)(1u << (7 - (pos & 7)));
      pos++;
    }
  }

  inline void unary(uint32_t q) {
    if (pos + q + 1 > cap * 8) { overflow = true; return; }
    pos += q;  // zeros are pre-cleared
    out[pos >> 3] |= (uint8_t)(1u << (7 - (pos & 7)));
    pos++;
  }

  inline void align_byte() { pos = (pos + 7) & ~7ll; }
  inline long long byte_pos() const { return pos >> 3; }
};

// ------------------------------------------------------------------- CRC

inline uint8_t crc8(const uint8_t* d, long long n) {  // poly 0x07, init 0
  uint8_t c = 0;
  for (long long i = 0; i < n; i++) {
    c ^= d[i];
    for (int k = 0; k < 8; k++) c = (c & 0x80) ? (uint8_t)((c << 1) ^ 0x07) : (uint8_t)(c << 1);
  }
  return c;
}

inline uint16_t crc16(const uint8_t* d, long long n) {  // poly 0x8005, init 0
  uint16_t c = 0;
  for (long long i = 0; i < n; i++) {
    c ^= (uint16_t)d[i] << 8;
    for (int k = 0; k < 8; k++) c = (c & 0x8000) ? (uint16_t)((c << 1) ^ 0x8005) : (uint16_t)(c << 1);
  }
  return c;
}

// ------------------------------------------------------------ decode core

const int kMaxChannels = 8;
const int kMaxBlock = 65535;

struct StreamInfo {
  int sample_rate = 0;
  int channels = 0;
  int bps = 0;
  long long total_samples = 0;
  uint8_t md5[16] = {0};
  long long frames_start = 0;  // byte offset of first frame
};

// Parse "fLaC" + metadata blocks. Returns 0 ok, <0 error.
int parse_streaminfo(const uint8_t* data, long long len, StreamInfo* si) {
  if (len < 4 + 4 + 34 || memcmp(data, "fLaC", 4) != 0) return -1;
  long long p = 4;
  bool have_si = false;
  while (p + 4 <= len) {
    uint8_t hdr = data[p];
    uint32_t blen = ((uint32_t)data[p + 1] << 16) | ((uint32_t)data[p + 2] << 8) | data[p + 3];
    p += 4;
    if (p + blen > len) return -2;  // truncated metadata
    if ((hdr & 0x7f) == 0) {        // STREAMINFO
      if (blen < 34) return -1;
      const uint8_t* b = data + p;
      si->sample_rate = ((int)b[10] << 12) | ((int)b[11] << 4) | (b[12] >> 4);
      si->channels = ((b[12] >> 1) & 0x7) + 1;
      si->bps = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1;
      si->total_samples = ((long long)(b[13] & 0x0f) << 32) | ((long long)b[14] << 24) |
                          ((long long)b[15] << 16) | ((long long)b[16] << 8) | b[17];
      memcpy(si->md5, b + 18, 16);
      have_si = true;
    }
    p += blen;
    if (hdr & 0x80) break;  // last-metadata-block flag
  }
  if (!have_si) return -1;
  si->frames_start = p;
  return 0;
}

// Residual for one subframe. buf[0..order) already holds warmups.
// Returns false on malformed input.
bool read_residual(BitReader& br, int64_t* buf, int blocksize, int order) {
  uint32_t method = (uint32_t)br.bits(2);
  if (method > 1) return false;
  int pbits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t po = (uint32_t)br.bits(4);
  uint32_t nparts = 1u << po;
  if ((blocksize >> po) == 0) return false;
  if ((blocksize % nparts) != 0) return false;
  int idx = order;
  for (uint32_t part = 0; part < nparts; part++) {
    int count = blocksize >> po;
    if (part == 0) count -= order;
    if (count < 0) return false;
    uint32_t param = (uint32_t)br.bits(pbits);
    if (param == escape) {
      uint32_t raw = (uint32_t)br.bits(5);
      for (int i = 0; i < count; i++) buf[idx++] = raw ? br.sbits(raw) : 0;
    } else {
      for (int i = 0; i < count; i++) {
        uint32_t q = br.unary();
        uint64_t v = ((uint64_t)q << param) | br.bits(param);
        buf[idx++] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
      }
    }
    if (br.overflow) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int64_t* buf, int blocksize, int bps) {
  if (br.bit() != 0) return false;  // mandatory zero pad
  uint32_t type = (uint32_t)br.bits(6);
  int wasted = 0;
  if (br.bit()) wasted = (int)br.unary() + 1;
  bps -= wasted;
  if (bps <= 0 || bps > 33) return false;

  if (type == 0) {  // CONSTANT
    int64_t v = br.sbits(bps);
    for (int i = 0; i < blocksize; i++) buf[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; i++) buf[i] = br.sbits(bps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED
    int order = type & 0x07;
    for (int i = 0; i < order; i++) buf[i] = br.sbits(bps);
    if (!read_residual(br, buf, blocksize, order)) return false;
    switch (order) {
      case 0: break;
      case 1:
        for (int i = 1; i < blocksize; i++) buf[i] += buf[i - 1];
        break;
      case 2:
        for (int i = 2; i < blocksize; i++) buf[i] += 2 * buf[i - 1] - buf[i - 2];
        break;
      case 3:
        for (int i = 3; i < blocksize; i++)
          buf[i] += 3 * buf[i - 1] - 3 * buf[i - 2] + buf[i - 3];
        break;
      case 4:
        for (int i = 4; i < blocksize; i++)
          buf[i] += 4 * buf[i - 1] - 6 * buf[i - 2] + 4 * buf[i - 3] - buf[i - 4];
        break;
    }
  } else if (type & 0x20) {  // LPC
    int order = (int)(type & 0x1f) + 1;
    for (int i = 0; i < order; i++) buf[i] = br.sbits(bps);
    int precision = (int)br.bits(4) + 1;
    if (precision == 16) return false;  // 0b1111 is invalid
    int shift = (int)br.sbits(5);
    if (shift < 0) return false;
    int64_t coef[32];
    for (int i = 0; i < order; i++) coef[i] = br.sbits(precision);
    if (!read_residual(br, buf, blocksize, order)) return false;
    for (int i = order; i < blocksize; i++) {
      int64_t acc = 0;
      for (int j = 0; j < order; j++) acc += coef[j] * buf[i - j - 1];
      buf[i] += acc >> shift;
    }
  } else {
    return false;  // reserved type
  }
  if (wasted)
    for (int i = 0; i < blocksize; i++) buf[i] = (int64_t)((uint64_t)buf[i] << wasted);
  return !br.overflow;
}

}  // namespace

extern "C" {

// Parse STREAMINFO only. Returns 0 ok, -1 malformed, -2 truncated.
int flac_probe(const uint8_t* data, long long len, int* sample_rate, int* channels,
               int* bps, long long* total_samples, uint8_t* md5_out) {
  StreamInfo si;
  int rc = parse_streaminfo(data, len, &si);
  if (rc != 0) return rc;
  *sample_rate = si.sample_rate;
  *channels = si.channels;
  *bps = si.bps;
  *total_samples = si.total_samples;
  memcpy(md5_out, si.md5, 16);
  return 0;
}

// Decode the full stream into interleaved int32 (caller sizes `out` as
// total_samples*channels from flac_probe). Returns decoded inter-channel
// sample count, or -1 malformed / -2 truncated. If `consumed` is non-null
// it receives the stream's byte length (for scanning concatenated blobs,
// e.g. extended kaldi arks).
long long flac_decode(const uint8_t* data, long long len, int32_t* out,
                      long long* consumed) {
  StreamInfo si;
  if (parse_streaminfo(data, len, &si) != 0) return -1;
  BitReader br(data, len);
  br.pos = si.frames_start * 8;

  static thread_local int64_t chbuf[kMaxChannels][kMaxBlock];
  long long done = 0;

  while (done < si.total_samples) {
    if (br.byte_pos() + 2 > len) return -2;
    // frame header
    if (br.bits(14) != 0x3ffe) return -1;
    br.bit();  // reserved
    br.bit();  // blocking strategy
    uint32_t bs_code = (uint32_t)br.bits(4);
    uint32_t sr_code = (uint32_t)br.bits(4);
    uint32_t ch_code = (uint32_t)br.bits(4);
    uint32_t ss_code = (uint32_t)br.bits(3);
    br.bit();  // reserved
    // UTF-8 coded frame/sample number: skip
    uint32_t first = (uint32_t)br.bits(8);
    int follow = 0;
    for (uint32_t m = 0x80; first & m; m >>= 1) follow++;
    if (follow == 1 || follow > 7) return -1;
    for (int i = 1; i < follow; i++) br.bits(8);

    int blocksize;
    switch (bs_code) {
      case 0: return -1;
      case 1: blocksize = 192; break;
      case 6: blocksize = (int)br.bits(8) + 1; break;
      case 7: blocksize = (int)br.bits(16) + 1; break;
      default:
        blocksize = bs_code <= 5 ? 576 << (bs_code - 2) : 256 << (bs_code - 8);
    }
    if (blocksize > kMaxBlock) return -1;
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    else if (sr_code == 15) return -1;
    br.bits(8);  // header CRC-8 (not verified; MD5 check covers payload)

    int channels = ch_code < 8 ? (int)ch_code + 1 : 2;
    if (ch_code > 10 || channels != si.channels) return -1;
    int bps;
    switch (ss_code) {
      case 0: bps = si.bps; break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return -1;
    }

    for (int c = 0; c < channels; c++) {
      int sub_bps = bps;
      if ((ch_code == 8 && c == 1) || (ch_code == 9 && c == 0) ||
          (ch_code == 10 && c == 1))
        sub_bps += 1;  // side channel carries one extra bit
      if (!decode_subframe(br, chbuf[c], blocksize, sub_bps))
        return br.overflow ? -2 : -1;
    }
    br.align_byte();
    br.bits(16);  // frame CRC-16 (not verified)
    if (br.overflow) return -2;

    // stereo decorrelation
    if (ch_code == 8) {        // left/side
      for (int i = 0; i < blocksize; i++) chbuf[1][i] = chbuf[0][i] - chbuf[1][i];
    } else if (ch_code == 9) { // right/side: ch0 = side, ch1 = right
      for (int i = 0; i < blocksize; i++) chbuf[0][i] = chbuf[0][i] + chbuf[1][i];
    } else if (ch_code == 10) {// mid/side
      for (int i = 0; i < blocksize; i++) {
        int64_t side = chbuf[1][i];
        int64_t mid = (chbuf[0][i] << 1) | (side & 1);
        chbuf[0][i] = (mid + side) >> 1;
        chbuf[1][i] = (mid - side) >> 1;
      }
    }

    long long take = blocksize;
    if (done + take > si.total_samples) take = si.total_samples - done;
    for (long long i = 0; i < take; i++)
      for (int c = 0; c < channels; c++)
        out[(done + i) * channels + c] = (int32_t)chbuf[c][i];
    done += take;
  }
  if (consumed) *consumed = br.byte_pos();
  return done;
}

// ------------------------------------------------------------ encode core

// Fixed-predictor FLAC encoder for int16 PCM (1-2 channels, the recipe
// regime). Valid per RFC 9639: correct CRC-8/CRC-16, rice partitions
// (order 0), verbatim fallback. `md5` is the caller-computed MD5 of the
// little-endian interleaved PCM. Returns bytes written, or -1 if out_cap
// is too small.
long long flac_encode16(const int16_t* pcm, long long n_samples, int channels,
                        int sample_rate, const uint8_t* md5, uint8_t* out,
                        long long out_cap) {
  if (channels < 1 || channels > 2 || n_samples < 0) return -1;
  const int kBlock = 4096;
  BitWriter bw(out, out_cap);

  // fLaC + STREAMINFO (last metadata block)
  bw.bits('f', 8); bw.bits('L', 8); bw.bits('a', 8); bw.bits('C', 8);
  bw.bits(0x80 | 0, 8);       // last=1, type=0
  bw.bits(34, 24);            // length
  bw.bits(kBlock, 16);        // min blocksize
  bw.bits(kBlock, 16);        // max blocksize
  long long framesize_pos = bw.pos;
  bw.bits(0, 24);             // min framesize (patched below)
  bw.bits(0, 24);             // max framesize (patched below)
  bw.bits((uint64_t)sample_rate, 20);
  bw.bits((uint64_t)(channels - 1), 3);
  bw.bits(16 - 1, 5);
  bw.bits((uint64_t)n_samples, 36);
  for (int i = 0; i < 16; i++) bw.bits(md5[i], 8);

  long long min_fs = 0x7fffffff, max_fs = 0;
  int64_t chan[2][kBlock];
  int64_t resid[kBlock];

  long long donesamp = 0;
  long long frame_idx = 0;
  while (donesamp < n_samples || (n_samples == 0 && frame_idx == 0)) {
    int blocksize = (int)((n_samples - donesamp) < kBlock ? (n_samples - donesamp) : kBlock);
    if (blocksize == 0) break;
    for (int i = 0; i < blocksize; i++)
      for (int c = 0; c < channels; c++)
        chan[c][i] = pcm[(donesamp + i) * channels + c];

    long long frame_start = bw.byte_pos();
    bw.bits(0x3ffe, 14);
    bw.bits(0, 1);  // reserved
    bw.bits(0, 1);  // fixed blocking
    int bs_code;
    bool bs_tail16 = false;
    if (blocksize == kBlock) bs_code = 12;       // 256 * 2^4
    else { bs_code = 7; bs_tail16 = true; }      // 16-bit at end
    bw.bits((uint64_t)bs_code, 4);
    int sr_code;
    bool sr_tail16 = false;
    switch (sample_rate) {
      case 88200: sr_code = 1; break;
      case 176400: sr_code = 2; break;
      case 192000: sr_code = 3; break;
      case 8000: sr_code = 4; break;
      case 16000: sr_code = 5; break;
      case 22050: sr_code = 6; break;
      case 24000: sr_code = 7; break;
      case 32000: sr_code = 8; break;
      case 44100: sr_code = 9; break;
      case 48000: sr_code = 10; break;
      case 96000: sr_code = 11; break;
      default: sr_code = 13; sr_tail16 = true;   // 16-bit Hz at end
    }
    bw.bits((uint64_t)sr_code, 4);
    bw.bits((uint64_t)(channels - 1), 4);  // independent channels
    bw.bits(4, 3);                          // 16 bps
    bw.bits(0, 1);                          // reserved
    // UTF-8 coded frame number
    uint64_t fn = (uint64_t)frame_idx;
    if (fn < 0x80) bw.bits(fn, 8);
    else if (fn < 0x800) { bw.bits(0xC0 | (fn >> 6), 8); bw.bits(0x80 | (fn & 0x3f), 8); }
    else if (fn < 0x10000) {
      bw.bits(0xE0 | (fn >> 12), 8);
      bw.bits(0x80 | ((fn >> 6) & 0x3f), 8);
      bw.bits(0x80 | (fn & 0x3f), 8);
    } else {
      bw.bits(0xF0 | (fn >> 18), 8);
      bw.bits(0x80 | ((fn >> 12) & 0x3f), 8);
      bw.bits(0x80 | ((fn >> 6) & 0x3f), 8);
      bw.bits(0x80 | (fn & 0x3f), 8);
    }
    if (bs_tail16) bw.bits((uint64_t)(blocksize - 1), 16);
    if (sr_tail16) bw.bits((uint64_t)sample_rate, 16);
    if (bw.overflow) return -1;
    bw.bits(crc8(out + frame_start, bw.byte_pos() - frame_start), 8);

    for (int c = 0; c < channels; c++) {
      // pick the fixed order (0-4) minimizing Σ|residual|
      int best_order = 0;
      unsigned long long best_sum = ~0ull;
      for (int order = 0; order <= 4 && order <= blocksize; order++) {
        unsigned long long s = 0;
        for (int i = order; i < blocksize; i++) {
          int64_t p = 0;
          switch (order) {
            case 1: p = chan[c][i - 1]; break;
            case 2: p = 2 * chan[c][i - 1] - chan[c][i - 2]; break;
            case 3: p = 3 * chan[c][i - 1] - 3 * chan[c][i - 2] + chan[c][i - 3]; break;
            case 4: p = 4 * chan[c][i - 1] - 6 * chan[c][i - 2] + 4 * chan[c][i - 3] - chan[c][i - 4]; break;
          }
          int64_t r = chan[c][i] - p;
          s += (unsigned long long)(r < 0 ? -r : r);
        }
        if (s < best_sum) { best_sum = s; best_order = order; }
      }
      int order = best_order;
      int nres = blocksize - order;
      for (int i = order; i < blocksize; i++) {
        int64_t p = 0;
        switch (order) {
          case 1: p = chan[c][i - 1]; break;
          case 2: p = 2 * chan[c][i - 1] - chan[c][i - 2]; break;
          case 3: p = 3 * chan[c][i - 1] - 3 * chan[c][i - 2] + chan[c][i - 3]; break;
          case 4: p = 4 * chan[c][i - 1] - 6 * chan[c][i - 2] + 4 * chan[c][i - 3] - chan[c][i - 4]; break;
        }
        resid[i - order] = chan[c][i] - p;
      }
      // rice parameter from mean magnitude (libFLAC-style estimate)
      unsigned long long sum = 0;
      for (int i = 0; i < nres; i++)
        sum += (unsigned long long)(resid[i] < 0 ? -resid[i] : resid[i]);
      int param = 0;
      while (param < 14 && ((unsigned long long)nres << (param + 1)) < sum) param++;
      // cost check: fall back to verbatim when rice would expand
      unsigned long long rice_bits = 0;
      for (int i = 0; i < nres && rice_bits < (1ull << 40); i++) {
        uint64_t zz = ((uint64_t)resid[i] << 1) ^ (uint64_t)(resid[i] >> 63);
        rice_bits += (zz >> param) + 1 + param;
      }
      bool verbatim = rice_bits > (unsigned long long)(17 * blocksize);

      if (verbatim) {
        bw.bits(0, 1); bw.bits(1, 6); bw.bits(0, 1);  // VERBATIM, no wasted bits
        for (int i = 0; i < blocksize; i++) bw.bits((uint64_t)chan[c][i] & 0xffff, 16);
      } else {
        bw.bits(0, 1); bw.bits((uint64_t)(8 + order), 6); bw.bits(0, 1);  // FIXED
        for (int i = 0; i < order; i++) bw.bits((uint64_t)chan[c][i] & 0xffff, 16);
        bw.bits(0, 2);                  // residual method: 4-bit rice
        bw.bits(0, 4);                  // partition order 0
        bw.bits((uint64_t)param, 4);
        for (int i = 0; i < nres; i++) {
          uint64_t zz = ((uint64_t)resid[i] << 1) ^ (uint64_t)(resid[i] >> 63);
          bw.unary((uint32_t)(zz >> param));
          bw.bits(zz & ((1ull << param) - 1), param);
        }
      }
      if (bw.overflow) return -1;
    }
    bw.align_byte();
    bw.bits(crc16(out + frame_start, bw.byte_pos() - frame_start), 16);
    if (bw.overflow) return -1;

    long long fs = bw.byte_pos() - frame_start;
    if (fs < min_fs) min_fs = fs;
    if (fs > max_fs) max_fs = fs;
    donesamp += blocksize;
    frame_idx++;
  }

  // patch min/max framesize into STREAMINFO
  long long total = bw.byte_pos();
  if (frame_idx > 0) {
    long long bytep = framesize_pos >> 3;  // framesize_pos is byte-aligned
    out[bytep + 0] = (uint8_t)(min_fs >> 16);
    out[bytep + 1] = (uint8_t)(min_fs >> 8);
    out[bytep + 2] = (uint8_t)min_fs;
    out[bytep + 3] = (uint8_t)(max_fs >> 16);
    out[bytep + 4] = (uint8_t)(max_fs >> 8);
    out[bytep + 5] = (uint8_t)max_fs;
  }
  return total;
}

}  // extern "C"
