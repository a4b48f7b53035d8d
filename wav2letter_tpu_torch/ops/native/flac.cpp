// Native FLAC decoder (data-loader path).
//
// The reference shells out to sox/flac for audio decode; this image has
// neither, and LibriSpeech/MLS ship FLAC. Implements the FLAC subset those
// corpora use (and more): CONSTANT/VERBATIM/FIXED/LPC subframes, all
// channel assignments (independent, left/side, right/side, mid/side), rice
// partitions incl. escape codes, wasted bits, 8/16/24-bit samples.
// CRC checks are skipped (decode-for-training path).
//
// C API: w2l_flac_read / w2l_flac_copy_free (ctypes, see __init__.py).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;
  int bit_pos = 0;  // 0..7, MSB first

  bool eof() const { return byte_pos >= size; }

  uint32_t read_bit() {
    if (byte_pos >= size) return 0;
    uint32_t b = (data[byte_pos] >> (7 - bit_pos)) & 1;
    if (++bit_pos == 8) {
      bit_pos = 0;
      byte_pos++;
    }
    return b;
  }

  uint64_t read_bits(int n) {
    uint64_t v = 0;
    while (n > 0) {
      if (byte_pos >= size) return v << n;
      if (bit_pos == 0 && n >= 8) {
        v = (v << 8) | data[byte_pos++];
        n -= 8;
      } else {
        v = (v << 1) | read_bit();
        n--;
      }
    }
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read_bits(n);
    if (n == 0) return 0;
    if (v & (1ULL << (n - 1))) return (int64_t)(v | (~0ULL << n));
    return (int64_t)v;
  }

  uint32_t read_unary() {
    uint32_t n = 0;
    while (!eof() && read_bit() == 0) n++;
    return n;
  }

  void align() {
    if (bit_pos) {
      bit_pos = 0;
      byte_pos++;
    }
  }
};

// UTF-8-style coded number (frame header sample/frame number)
uint64_t read_utf8(BitReader& br) {
  uint32_t b0 = (uint32_t)br.read_bits(8);
  if ((b0 & 0x80) == 0) return b0;
  int n = 0;
  for (uint32_t m = 0x40; b0 & m; m >>= 1) n++;
  uint64_t v = b0 & (0x3F >> n);
  for (int i = 0; i < n; i++) v = (v << 6) | (br.read_bits(8) & 0x3F);
  return v;
}

int64_t rice_read(BitReader& br, int param) {
  uint32_t q = br.read_unary();
  uint64_t r = br.read_bits(param);
  uint64_t u = ((uint64_t)q << param) | r;
  return (u >> 1) ^ -(int64_t)(u & 1);  // zigzag
}

bool decode_residual(BitReader& br, int order, int blocksize,
                     std::vector<int64_t>& out) {
  int method = (int)br.read_bits(2);  // 0 rice4, 1 rice5
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  int esc = method == 0 ? 15 : 31;
  int partition_order = (int)br.read_bits(4);
  int n_part = 1 << partition_order;
  int idx = order;
  for (int p = 0; p < n_part; p++) {
    int count = blocksize >> partition_order;
    if (p == 0) count -= order;
    int param = (int)br.read_bits(plen);
    if (param == esc) {
      int bits = (int)br.read_bits(5);
      for (int i = 0; i < count; i++) out[idx++] = br.read_signed(bits);
    } else {
      for (int i = 0; i < count; i++) out[idx++] = rice_read(br, param);
    }
  }
  return true;
}

const int FIXED_COEFS[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

bool decode_subframe(BitReader& br, int blocksize, int bps,
                     std::vector<int64_t>& out) {
  br.read_bit();  // zero pad bit
  int type = (int)br.read_bits(6);
  int wasted = 0;
  if (br.read_bit()) wasted = 1 + (int)br.read_unary();
  bps -= wasted;
  out.assign(blocksize, 0);
  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < blocksize; i++) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; i++) out[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED order 0-4
    int order = type - 8;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(bps);
    if (!decode_residual(br, order, blocksize, out)) return false;
    for (int i = order; i < blocksize; i++) {
      int64_t pred = 0;
      for (int j = 0; j < order; j++)
        pred += (int64_t)FIXED_COEFS[order][j] * out[i - 1 - j];
      out[i] += pred;
    }
  } else if (type >= 32) {  // LPC order 1-32
    int order = type - 31;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(bps);
    int precision = (int)br.read_bits(4) + 1;
    int shift = (int)br.read_signed(5);
    std::vector<int64_t> coefs(order);
    for (int i = 0; i < order; i++) coefs[i] = br.read_signed(precision);
    if (!decode_residual(br, order, blocksize, out)) return false;
    for (int i = order; i < blocksize; i++) {
      int64_t pred = 0;
      for (int j = 0; j < order; j++) pred += coefs[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    return false;
  }
  if (wasted)
    for (auto& v : out) v <<= wasted;
  return true;
}

struct FlacData {
  std::vector<float> samples;  // interleaved
  int sample_rate = 0;
  int channels = 0;
};

FlacData* decode_flac(const char* path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return nullptr;
  std::vector<uint8_t> buf((std::istreambuf_iterator<char>(f)),
                           std::istreambuf_iterator<char>());
  if (buf.size() < 42 || memcmp(buf.data(), "fLaC", 4) != 0) return nullptr;

  size_t pos = 4;
  int sample_rate = 0, channels = 0, bps = 0;
  uint64_t total_samples = 0;
  // metadata blocks
  while (pos + 4 <= buf.size()) {
    uint8_t hdr = buf[pos];
    bool last = hdr & 0x80;
    int type = hdr & 0x7F;
    uint32_t len = (buf[pos + 1] << 16) | (buf[pos + 2] << 8) | buf[pos + 3];
    pos += 4;
    if (type == 0 && len >= 34) {  // STREAMINFO
      const uint8_t* d = buf.data() + pos;
      sample_rate = (d[10] << 12) | (d[11] << 4) | (d[12] >> 4);
      channels = ((d[12] >> 1) & 0x7) + 1;
      bps = (((d[12] & 1) << 4) | (d[13] >> 4)) + 1;
      total_samples = ((uint64_t)(d[13] & 0x0F) << 32) | ((uint64_t)d[14] << 24) |
                      (d[15] << 16) | (d[16] << 8) | d[17];
    }
    pos += len;
    if (last) break;
  }
  if (!sample_rate || !channels) return nullptr;

  auto* out = new FlacData();
  out->sample_rate = sample_rate;
  out->channels = channels;
  if (total_samples) out->samples.reserve(total_samples * channels);

  BitReader br{buf.data(), buf.size()};
  br.byte_pos = pos;

  std::vector<std::vector<int64_t>> ch(channels);
  const double scale = 1.0 / (double)(1LL << (bps - 1));

  while (br.byte_pos + 2 < br.size) {
    // find frame sync 11111111 111110xx
    uint32_t sync = (uint32_t)br.read_bits(14);
    if (br.eof()) break;
    if (sync != 0x3FFE) {  // resync byte-wise
      br.align();
      continue;
    }
    br.read_bit();  // reserved
    br.read_bit();  // blocking strategy
    int bs_code = (int)br.read_bits(4);
    int sr_code = (int)br.read_bits(4);
    int ch_code = (int)br.read_bits(4);
    int ss_code = (int)br.read_bits(3);
    br.read_bit();  // reserved
    read_utf8(br);  // frame/sample number
    int blocksize;
    switch (bs_code) {
      case 1: blocksize = 192; break;
      case 2: case 3: case 4: case 5:
        blocksize = 576 << (bs_code - 2); break;
      case 6: blocksize = (int)br.read_bits(8) + 1; break;
      case 7: blocksize = (int)br.read_bits(16) + 1; break;
      default: blocksize = 256 << (bs_code - 8); break;
    }
    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);
    int fbps = bps;
    switch (ss_code) {
      case 1: fbps = 8; break;
      case 2: fbps = 12; break;
      case 4: fbps = 16; break;
      case 5: fbps = 20; break;
      case 6: fbps = 24; break;
      case 7: fbps = 32; break;
      default: break;  // 0 = streaminfo
    }
    br.read_bits(8);  // CRC-8 (unchecked)

    int n_ch = channels;
    bool left_side = false, right_side = false, mid_side = false;
    if (ch_code >= 8) {
      n_ch = 2;
      left_side = ch_code == 8;
      right_side = ch_code == 9;
      mid_side = ch_code == 10;
    } else {
      n_ch = ch_code + 1;
    }

    bool ok = true;
    for (int c = 0; c < n_ch && ok; c++) {
      int sub_bps = fbps;
      if ((left_side && c == 1) || (right_side && c == 0) ||
          (mid_side && c == 1))
        sub_bps += 1;  // side channel has one extra bit
      ok = decode_subframe(br, blocksize, sub_bps, ch[c]);
    }
    if (!ok) break;
    br.align();
    br.read_bits(16);  // CRC-16 (unchecked)

    // stereo decorrelation
    if (left_side) {
      for (int i = 0; i < blocksize; i++) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (right_side) {
      for (int i = 0; i < blocksize; i++) ch[0][i] = ch[1][i] + ch[0][i];
    } else if (mid_side) {
      for (int i = 0; i < blocksize; i++) {
        int64_t side = ch[1][i];
        int64_t mid = (ch[0][i] << 1) | (side & 1);
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    }
    for (int i = 0; i < blocksize; i++)
      for (int c = 0; c < n_ch; c++)
        out->samples.push_back((float)(ch[c][i] * scale));
    if (total_samples && out->samples.size() >= total_samples * channels) break;
  }
  if (total_samples && out->samples.size() > total_samples * channels)
    out->samples.resize(total_samples * channels);
  return out;
}

}  // namespace

extern "C" {

void* w2l_flac_read(const char* path, int64_t* n_out, int* sr_out, int* ch_out) {
  FlacData* d = decode_flac(path);
  if (!d) return nullptr;
  *n_out = (int64_t)d->samples.size();
  *sr_out = d->sample_rate;
  *ch_out = d->channels;
  return d;
}

void w2l_flac_copy_free(void* handle, float* dst, int64_t n) {
  auto* d = static_cast<FlacData*>(handle);
  memcpy(dst, d->samples.data(),
         (size_t)std::min<int64_t>(n, (int64_t)d->samples.size()) * sizeof(float));
  delete d;
}

}  // extern "C"
