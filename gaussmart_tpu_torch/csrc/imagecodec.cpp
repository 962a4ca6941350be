// Host image codec of the port: a JPEG decoder equal to the bit to
// libjpeg-turbo as Pillow and OpenCV call it, a JPEG encoder whose files
// equal to the byte what Pillow's Image.save writes with no options, and
// the PNG row unfilter, and an intra-only MPEG-4 Part 2 (Simple Profile)
// video encoder.
//
// Decoder: baseline, extended-Huffman and progressive 8-bit frames of 1
// or 3 components, any integral sampling factors, restart intervals. It
// copies libjpeg-turbo's default decompression: the integer IDCT of
// jidctint.c with its descaling and range limit, fancy upsampling
// (jdsample.c: triangular h2v1/h2v2/h1v2 filters, box replication where
// the chroma is at most 2 samples wide or the factor is another integer),
// the fixed-point YCbCr->RGB of jdcolor.c, the colour space rules of
// jdapimin.c (JFIF, Adobe APP14 transform, component ids) and the
// replacement of missing data by zeros after a marker. Every read is
// bounds-checked: any byte string gives an image or an error message.
//
// Encoder: jpeg_set_defaults + jpeg_set_quality(q, TRUE) + the JFIF 1.01
// header and an optional COM segment after it (Pillow's `comment`), i.e.
// baseline with the standard Huffman tables, RGB as YCbCr
// 4:2:0 (jccolor.c, h2v2_downsample with its alternating bias), grey as
// one component, the integer FDCT of jfdctint.c and libjpeg-turbo's
// reciprocal quantization.
//
// C interface (all functions return 0 on success, otherwise write a
// message into err and return 1):
//   gm_jpeg_info(data, n, info[3], err, errlen)     width, height, channels
//   gm_jpeg_decode(data, n, out, cap, err, errlen)  uint8 HxWxC into out
//   gm_jpeg_encode(px, w, h, c, quality, com, comlen, &out, &len, err, errlen)
//   gm_mp4v_encode(rgb, n, w, h, fps, quant, &out, &len, lens, err, errlen)
//   gm_free(out)
//   gm_png_unfilter(raw, h, stride, bpp, out, err, errlen)
//   gm_resample_u8(in, outer, len, inner, out_len, k, taps, weights, out)
//
// gm_resample_u8 is the accumulate pass of Pillow's 8-bit resampler
// (libImaging/Resample.c) along the middle axis of an [outer, len, inner]
// array, with the taps and fixed-point weights computed by the caller.
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct CodecError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw CodecError{msg}; }

// zigzag index -> natural index; 16 extra entries absorb runs that
// corrupt data pushes past coefficient 63 (as jpeg_natural_order does)
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Annex K tables (jcparam.c / jstdhuff.c)
const uint8_t kStdLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// fixed-point constants of jidctint.c / jfdctint.c (CONST_BITS = 13)
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// Pillow's decompression-bomb limit (2 * Image.MAX_IMAGE_PIXELS)
constexpr uint64_t kMaxPixels = 2ull * 89478485ull;

// ---------------------------------------------------------------------------
// Huffman tables
// ---------------------------------------------------------------------------

struct HuffSpec {
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int count = 0;
  bool present = false;
};

void std_huff(HuffSpec* h, bool dc, int tbl) {
  const uint8_t* bits = dc ? (tbl ? kDcChromaBits : kDcLumaBits)
                           : (tbl ? kAcChromaBits : kAcLumaBits);
  const uint8_t* vals = dc ? kDcVals : (tbl ? kAcChromaVals : kAcLumaVals);
  std::memcpy(h->bits, bits, 17);
  h->count = 0;
  for (int l = 1; l <= 16; ++l) h->count += bits[l];
  std::memcpy(h->vals, vals, h->count);
  h->present = true;
}

// jpeg_make_d_derived_tbl: canonical codes, maxcode/valoffset per length
// and an 8-bit lookahead table
struct DecHuff {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint8_t look_nbits[256];
  uint8_t look_sym[256];

  void build(const HuffSpec& spec, bool dc) {
    uint8_t huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      int n = spec.bits[l];
      if (p + n > 256) fail("bad Huffman table");
      while (n--) huffsize[p++] = uint8_t(l);
    }
    huffsize[p] = 0;
    int numsymbols = p;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (uint32_t(1) << si)) fail("bad Huffman table");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (spec.bits[l]) {
        valoffset[l] = p - int32_t(huffcode[p]);
        p += spec.bits[l];
        maxcode[l] = int32_t(huffcode[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0x7FFFFFFF;  // ensures the slow decode terminates
    std::memcpy(vals, spec.vals, 256);
    std::memset(look_nbits, 0, sizeof(look_nbits));
    p = 0;
    for (int l = 1; l <= 8; ++l) {
      for (int i = 1; i <= spec.bits[l]; ++i, ++p) {
        int lookbits = int(huffcode[p]) << (8 - l);
        for (int ctr = 1 << (8 - l); ctr > 0; --ctr) {
          look_nbits[lookbits] = uint8_t(l);
          look_sym[lookbits] = spec.vals[p];
          ++lookbits;
        }
      }
    }
    if (dc) {
      for (int i = 0; i < numsymbols; ++i)
        if (spec.vals[i] > 15) fail("bad Huffman table");
    }
  }
};

// ---------------------------------------------------------------------------
// Entropy-coded segment reader
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0;
  size_t pos = 0;         // next byte to read
  uint64_t acc = 0;       // bits, MSB first, in the low `bits` bits
  int bits = 0;
  int phantom = 0;        // zero bits appended past the end of the data
  int marker_pad = 0;     // zero bits appended in front of a marker
  bool at_marker = false; // stopped in front of the marker at `pos`
  bool truncated = false; // a decode used bits past the end of the data
  bool exhausted = false; // a decode used bits past a marker

  void reset(size_t p) {
    pos = p;
    acc = 0;
    bits = 0;
    phantom = 0;
    marker_pad = 0;
    at_marker = false;
    exhausted = false;
  }

  void fill() {
    while (bits <= 56) {
      uint32_t c;
      if (at_marker) {
        c = 0;
        marker_pad += 8;
      } else if (pos >= n) {
        c = 0;
        phantom += 8;
      } else {
        c = d[pos];
        if (c == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;
          if (q >= n) {           // the data ends inside FF fill bytes
            pos = n;
            c = 0;
            phantom += 8;
          } else if (d[q] == 0) { // FF 00 stands for an FF data byte
            pos = q + 1;
          } else {                // a marker ends the segment
            pos = q - 1;
            at_marker = true;
            c = 0;
          }
        } else {
          ++pos;
        }
      }
      acc = (acc << 8) | c;
      bits += 8;
    }
  }

  inline int peek(int k) {
    if (bits < k) fill();
    return int((acc >> (bits - k)) & ((uint64_t(1) << k) - 1));
  }
  inline void skip(int k) {
    bits -= k;
    if (bits < phantom) truncated = true;
    if (bits < marker_pad) exhausted = true;
  }
  inline int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }

  int decode(const DecHuff& h) {
    int look = peek(8);
    int nb = h.look_nbits[look];
    if (nb) {
      skip(nb);
      return h.look_sym[look];
    }
    int code = peek(16);
    int l = 9;
    while (l <= 16 && (code >> (16 - l)) > h.maxcode[l]) ++l;
    if (l > 16) {  // corrupt data: libjpeg warns, takes 17 bits, gives 0
      peek(17);
      skip(17);
      return 0;
    }
    skip(l);
    int idx = (code >> (16 - l)) + h.valoffset[l];
    return h.vals[idx & 0xFF];
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + int((unsigned(-1) << s) + 1) : v;
}

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int width = 0, height = 0;  // downsampled size in samples
  int wib = 0, hib = 0;       // blocks holding real samples
  int bw = 0, bh = 0;         // allocated blocks (whole MCUs)
  std::vector<int16_t> coef;  // bw*bh blocks of 64, natural order
  uint16_t quant[64];
  bool quant_latched = false;
  int coef_bits[64];          // progressive: -1 not yet sent, else Al
  int dc_pred = 0;
  int dc_tbl = 0, ac_tbl = 0;
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;

  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  HuffSpec dc_spec[4], ac_spec[4];
  int restart_interval = 0;
  bool have_frame = false;
  bool progressive = false;
  int width = 0, height = 0;
  int max_h = 1, max_v = 1;
  int mcus_x = 0, mcus_y = 0;
  std::vector<Component> comps;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool allocated = false;

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}

  int byte() {
    if (pos >= n) fail("image file is truncated");
    return d[pos++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // next_marker: skip to FF xx (xx not 0, not FF); returns xx
  int next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void segment_bounds(int* len) {
    *len = u16();
    if (*len < 2) fail("bad JPEG marker length");
    if (pos + size_t(*len - 2) > n) fail("image file is truncated");
  }

  void get_dqt() {
    int len;
    segment_bounds(&len);
    size_t end = pos + len - 2;
    while (pos < end) {
      int pq = byte();
      int tq = pq & 15;
      pq >>= 4;
      if (tq > 3) fail("bad JPEG quantization table number");
      if (pq > 1) fail("bad JPEG quantization table precision");
      if (pos + (pq ? 128 : 64) > end) fail("bad JPEG marker length");
      for (int i = 0; i < 64; ++i)
        qt[tq][kNatural[i]] = uint16_t(pq ? u16() : byte());
      qt_present[tq] = true;
    }
    if (pos != end) fail("bad JPEG marker length");
  }

  void get_dht() {
    int len;
    segment_bounds(&len);
    size_t end = pos + len - 2;
    while (pos + 17 <= end) {
      int index = byte();
      HuffSpec spec;
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        spec.bits[l] = uint8_t(byte());
        count += spec.bits[l];
      }
      if (count > 256 || pos + size_t(count) > end) fail("bad Huffman table");
      for (int i = 0; i < count; ++i) spec.vals[i] = uint8_t(byte());
      spec.count = count;
      spec.present = true;
      int tbl = index & 15;
      if (tbl > 3 || (index & ~0x1F)) fail("bad Huffman table number");
      if (index & 0x10)
        ac_spec[tbl] = spec;
      else
        dc_spec[tbl] = spec;
    }
    if (pos != end) fail("bad JPEG marker length");
  }

  void get_dri() {
    int len = u16();
    if (len != 4) fail("bad JPEG marker length");
    restart_interval = u16();
  }

  void get_app(int marker) {
    int len;
    segment_bounds(&len);
    size_t body = pos;
    size_t blen = size_t(len - 2);
    if (marker == 0xE0 && blen >= 14 && std::memcmp(d + body, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && blen >= 12 && std::memcmp(d + body, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = d[body + 11];
    }
    pos = body + blen;
  }

  void skip_segment() {
    int len;
    segment_bounds(&len);
    pos += size_t(len - 2);
  }

  void get_sof(int marker) {
    switch (marker) {
      case 0xC0: case 0xC1: case 0xC2: break;
      case 0xC3: fail("lossless JPEG (SOF3) is not supported");
      case 0xC5: case 0xC6: case 0xC7:
      case 0xCD: case 0xCE: case 0xCF:
        fail("hierarchical JPEG (differential SOF) is not supported");
      case 0xC9: case 0xCA: fail("arithmetic-coded JPEG is not supported");
      case 0xCB: fail("arithmetic-coded lossless JPEG is not supported");
      default: fail("unsupported JPEG SOF marker");
    }
    if (have_frame) fail("JPEG with two SOF markers");
    int len;
    segment_bounds(&len);
    int precision = byte();
    height = u16();
    width = u16();
    int nc = byte();
    if (len != 8 + 3 * nc) fail("bad JPEG SOF marker length");
    if (precision != 8)
      fail(std::to_string(precision) + "-bit JPEG is not supported (8-bit only)");
    if (nc == 4) fail("CMYK/YCCK JPEG (4 components) is not supported");
    if (nc != 1 && nc != 3)
      fail("JPEG with " + std::to_string(nc) + " components is not supported");
    if (height == 0) fail("JPEG with its height in a DNL marker is not supported");
    if (width == 0) fail("empty JPEG image");
    if (uint64_t(width) * uint64_t(height) > kMaxPixels)
      fail("image of " + std::to_string(width) + "x" + std::to_string(height) +
           " pixels exceeds the decompression-bomb limit");
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("bad JPEG sampling factors");
      if (c.tq > 3) fail("bad JPEG quantization table number");
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    for (auto& c : comps) {
      if (max_h % c.h || max_v % c.v)
        fail("JPEG with fractional sampling factors is not supported");
      c.width = int((int64_t(width) * c.h + max_h - 1) / max_h);
      c.height = int((int64_t(height) * c.v + max_v - 1) / max_v);
      c.wib = (c.width + 7) / 8;
      c.hib = (c.height + 7) / 8;
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
    mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
    progressive = marker == 0xC2;
    have_frame = true;
  }

  // header up to the first SOS; leaves pos at that SOS's length field
  int read_header() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xDA) {
        if (!have_frame) fail("JPEG SOS before SOF");
        return m;
      }
      handle_marker(m);
    }
  }

  void handle_marker(int m) {
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      get_sof(m);
    } else if (m == 0xC4) {
      get_dht();
    } else if (m == 0xCC) {
      fail("arithmetic-coded JPEG (DAC marker) is not supported");
    } else if (m == 0xDB) {
      get_dqt();
    } else if (m == 0xDD) {
      get_dri();
    } else if (m >= 0xE0 && m <= 0xEF) {
      get_app(m);
    } else if (m == 0xFE || m == 0xDC) {  // COM, DNL
      skip_segment();
    } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      // RSTn, TEM: parameterless, ignored
    } else if (m == 0xD8) {
      fail("JPEG with two SOI markers");
    } else if (m == 0xD9) {
      fail("JPEG datastream contains no image");
    } else if (m == 0xDE) {
      fail("hierarchical JPEG (DHP marker) is not supported");
    } else {
      static const char hex[] = "0123456789ABCDEF";
      fail(std::string("unknown JPEG marker 0xFF") + hex[m >> 4] + hex[m & 15]);
    }
  }

  void allocate() {
    if (allocated) return;
    for (auto& c : comps) {
      c.bw = mcus_x * c.h;
      c.bh = mcus_y * c.v;
      c.coef.assign(size_t(c.bw) * size_t(c.bh) * 64, 0);
    }
    allocated = true;
  }

  // ---- one scan -----------------------------------------------------------

  struct Scan {
    int n = 0;
    int idx[4];
    int ss = 0, se = 63, ah = 0, al = 0;
  };

  DecHuff dec_dc[4], dec_ac[4];

  Scan read_sos() {
    int len;
    segment_bounds(&len);
    Scan s;
    s.n = byte();
    if (s.n < 1 || s.n > 4 || len != 6 + 2 * s.n) fail("bad JPEG SOS marker");
    bool used[4] = {false, false, false, false};
    for (int i = 0; i < s.n; ++i) {
      int cid = byte();
      int tables = byte();
      int found = -1;
      for (int k = 0; k < int(comps.size()); ++k) {
        if (comps[k].id == cid && !used[k]) { found = k; break; }
      }
      if (found < 0) fail("bad JPEG component id in SOS");
      used[found] = true;
      s.idx[i] = found;
      comps[found].dc_tbl = tables >> 4;
      comps[found].ac_tbl = tables & 15;
      if (comps[found].dc_tbl > 3 || comps[found].ac_tbl > 3)
        fail("bad Huffman table number");
    }
    s.ss = byte();
    s.se = byte();
    int a = byte();
    s.ah = a >> 4;
    s.al = a & 15;
    if (s.n > 1) {
      int blocks = 0;
      for (int i = 0; i < s.n; ++i) blocks += comps[s.idx[i]].h * comps[s.idx[i]].v;
      if (blocks > 10) fail("bad JPEG MCU size");
    }
    return s;
  }

  void latch_tables(const Scan& s) {
    for (int i = 0; i < s.n; ++i) {
      Component& c = comps[s.idx[i]];
      if (!c.quant_latched) {
        if (!qt_present[c.tq]) fail("JPEG quantization table missing");
        std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
        c.quant_latched = true;
      }
    }
    bool need_dc = !progressive || s.ss == 0;
    bool need_ac = !progressive || s.ss != 0;
    if (progressive && s.ah != 0 && s.ss == 0) need_dc = false;  // DC refine
    for (int i = 0; i < s.n; ++i) {
      Component& c = comps[s.idx[i]];
      if (need_dc) build_table(true, c.dc_tbl);
      if (need_ac) build_table(false, c.ac_tbl);
    }
  }

  void build_table(bool dc, int tbl) {
    HuffSpec* spec = dc ? &dc_spec[tbl] : &ac_spec[tbl];
    HuffSpec fallback;
    if (!spec->present) {
      // libjpeg-turbo supplies the Annex K tables for Motion-JPEG frames
      if (tbl > 1) fail("JPEG Huffman table missing");
      std_huff(&fallback, dc, tbl);
      spec = &fallback;
    }
    (dc ? dec_dc : dec_ac)[tbl].build(*spec, dc);
  }

  void check_progression(const Scan& s) {
    bool bad = false;
    if (s.ss == 0) {
      if (s.se != 0) bad = true;
    } else {
      if (s.ss > s.se || s.se > 63) bad = true;
      if (s.n != 1) bad = true;
    }
    if (s.ah != 0 && s.al != s.ah - 1) bad = true;
    if (s.al > 13) bad = true;
    if (bad) fail("bad JPEG progression parameters");
    for (int i = 0; i < s.n; ++i) {
      Component& c = comps[s.idx[i]];
      for (int k = s.ss; k <= s.se; ++k) c.coef_bits[k] = s.al;
    }
  }

  void decode_scan(const Scan& s) {
    allocate();
    if (progressive) check_progression(s);
    latch_tables(s);
    for (int i = 0; i < s.n; ++i) comps[s.idx[i]].dc_pred = 0;

    BitReader br;
    br.d = d;
    br.n = n;
    br.reset(pos);

    int units_x, units_y;
    if (s.n == 1) {
      units_x = comps[s.idx[0]].wib;
      units_y = comps[s.idx[0]].hib;
    } else {
      units_x = mcus_x;
      units_y = mcus_y;
    }
    int64_t total = int64_t(units_x) * units_y;
    int eobrun = 0;
    int restarts_to_go = restart_interval;
    int next_rst = 0;
    bool insufficient = false;

    for (int64_t mcu = 0; mcu < total; ++mcu) {
      if (restart_interval) {
        if (restarts_to_go == 0) {
          process_restart(&br, &next_rst);
          for (int i = 0; i < s.n; ++i) comps[s.idx[i]].dc_pred = 0;
          eobrun = 0;
          insufficient = false;
          restarts_to_go = restart_interval;
        }
      }
      if (!insufficient) {
        int mx = int(mcu % units_x), my = int(mcu / units_x);
        if (s.n == 1) {
          decode_block(s, comps[s.idx[0]], mx, my, &br, &eobrun);
        } else {
          for (int i = 0; i < s.n; ++i) {
            Component& c = comps[s.idx[i]];
            for (int by = 0; by < c.v; ++by)
              for (int bx = 0; bx < c.h; ++bx)
                decode_block(s, c, mx * c.h + bx, my * c.v + by, &br, &eobrun);
          }
        }
        if (br.truncated) fail("image file is truncated");
        // past a marker libjpeg leaves the segment's remaining MCUs zero
        if (br.exhausted) insufficient = true;
      }
      if (restart_interval) --restarts_to_go;
    }
    // the bytes buffered beyond the last MCU are skipped: at_marker left
    // br.pos on the FF of the next marker, else next_marker finds it
    pos = br.pos;
  }

  void process_restart(BitReader* br, int* next_rst) {
    // the buffered bits are dropped, as libjpeg discards them
    pos = br->pos;
    int m = next_marker();  // at_marker leaves pos at FF; next_marker reads it
    if (m != 0xD0 + *next_rst) {
      // jpeg_resync_to_restart
      for (;;) {
        int action;
        if (m < 0xC0) {
          action = 2;
        } else if (m < 0xD0 || m > 0xD7) {
          action = 3;
        } else if (m == 0xD0 + ((*next_rst + 1) & 7) || m == 0xD0 + ((*next_rst + 2) & 7)) {
          action = 3;
        } else if (m == 0xD0 + ((*next_rst - 1) & 7) || m == 0xD0 + ((*next_rst - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 1) break;
        if (action == 2) {
          m = next_marker();
          continue;
        }
        // action 3: leave the marker unread; the segment decodes as zeros
        // pos is past the marker byte: step back to its FF
        pos -= 2;
        br->reset(pos);
        br->at_marker = true;
        *next_rst = (*next_rst + 1) & 7;
        return;
      }
    }
    br->reset(pos);
    *next_rst = (*next_rst + 1) & 7;
  }

  void decode_block(const Scan& s, Component& c, int bx, int by, BitReader* br, int* eobrun) {
    int16_t* blk = &c.coef[(size_t(by) * c.bw + bx) * 64];
    if (!progressive) {
      const DecHuff& dct = dec_dc[c.dc_tbl];
      const DecHuff& act = dec_ac[c.ac_tbl];
      int t = br->decode(dct);
      int diff = t ? extend(br->get(t), t) : 0;
      c.dc_pred = int(unsigned(c.dc_pred) + unsigned(diff));
      blk[0] = int16_t(c.dc_pred);
      for (int k = 1; k < 64; ++k) {
        int rs = br->decode(act);
        int r = rs >> 4, sz = rs & 15;
        if (sz) {
          k += r;
          int v = extend(br->get(sz), sz);
          blk[kNatural[k]] = int16_t(v);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (s.ss == 0) {
      if (s.ah == 0) {
        int t = br->decode(dec_dc[c.dc_tbl]);
        int diff = t ? extend(br->get(t), t) : 0;
        c.dc_pred = int(unsigned(c.dc_pred) + unsigned(diff));
        blk[0] = int16_t(unsigned(c.dc_pred) << s.al);
      } else {
        if (br->get(1)) blk[0] = int16_t(blk[0] | (1 << s.al));
      }
      return;
    }
    const DecHuff& act = dec_ac[c.ac_tbl];
    if (s.ah == 0) {
      if (*eobrun > 0) {
        --*eobrun;
        return;
      }
      for (int k = s.ss; k <= s.se; ++k) {
        int rs = br->decode(act);
        int r = rs >> 4, sz = rs & 15;
        if (sz) {
          k += r;
          int v = extend(br->get(sz), sz);
          blk[kNatural[k]] = int16_t(unsigned(v) << s.al);
        } else {
          if (r == 15) {
            k += 15;
          } else {
            *eobrun = 1 << r;
            if (r) *eobrun += br->get(r);
            --*eobrun;
            break;
          }
        }
      }
      return;
    }
    // AC refinement
    int p1 = 1 << s.al;
    int m1 = int(unsigned(-1) << s.al);
    int k = s.ss;
    if (*eobrun == 0) {
      for (; k <= s.se; ++k) {
        int rs = br->decode(act);
        int r = rs >> 4, sz = rs & 15;
        int val = 0;
        if (sz) {
          val = br->get(1) ? p1 : m1;
        } else if (r != 15) {
          *eobrun = 1 << r;
          if (r) *eobrun += br->get(r);
          break;
        }
        do {
          int16_t* coef = &blk[kNatural[k]];
          if (*coef != 0) {
            if (br->get(1)) {
              if ((*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= s.se);
        if (val) blk[kNatural[k]] = int16_t(val);
      }
    }
    if (*eobrun > 0) {
      for (; k <= s.se; ++k) {
        int16_t* coef = &blk[kNatural[k]];
        if (*coef != 0) {
          if (br->get(1)) {
            if ((*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
          }
        }
      }
      --*eobrun;
    }
  }

  // ---- whole stream ---------------------------------------------------------

  // every scan after read_header(), up to EOI
  void decode_scans() {
    for (;;) {
      // pos is just after an SOS marker
      Scan s = read_sos();
      decode_scan(s);
      // the marker after the scan; a stream that ends without one is
      // truncated (libjpeg suspends there, and Pillow raises)
      int m = next_marker();
      for (;;) {
        if (m == 0xD9) return;
        if (m == 0xDA) break;
        handle_marker(m);
        m = next_marker();
      }
    }
  }

  // jdcoefct.c smoothing_ok: libjpeg would smooth the blocks of a
  // progressive image whose low AC coefficients are incomplete
  bool block_smoothing_would_apply() const {
    if (!progressive) return false;
    static const int kSaved[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (const auto& c : comps) {
      if (!c.quant_latched) return false;
      for (int i = 0; i < 10; ++i)
        if (c.quant[kSaved[i]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }
};

// ---- IDCT (jidctint.c jpeg_idct_islow) --------------------------------------

struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    // post-IDCT table of prepare_range_limit_table, indexed by x & 1023
    for (int i = 0; i < 1024; ++i) {
      int v;
      if (i < 128) v = i + 128;
      else if (i < 512) v = 255;
      else if (i < 896) v = 0;
      else v = i - 896;
      t[i] = uint8_t(v);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, size_t stride) {
  int ws[64];
  for (int col = 0; col < 8; ++col) {
    const int16_t* ip = in + col;
    const uint16_t* qp = q + col;
    int* wp = ws + col;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      int dc = int(ip[0]) * int(qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16];
    int64_t z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = int(descale(tmp10 + tmp3, sh));
    wp[56] = int(descale(tmp10 - tmp3, sh));
    wp[8] = int(descale(tmp11 + tmp2, sh));
    wp[48] = int(descale(tmp11 - tmp2, sh));
    wp[16] = int(descale(tmp12 + tmp1, sh));
    wp[40] = int(descale(tmp12 - tmp1, sh));
    wp[24] = int(descale(tmp13 + tmp0, sh));
    wp[32] = int(descale(tmp13 - tmp0, sh));
  }
  const uint8_t* rl = kRange.t;
  for (int row = 0; row < 8; ++row) {
    const int* wp = ws + 8 * row;
    uint8_t* op = out + row * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      uint8_t v = rl[int(descale(wp[0], kPass1Bits + 3)) & 1023];
      for (int i = 0; i < 8; ++i) op[i] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    op[0] = rl[int(descale(tmp10 + tmp3, sh)) & 1023];
    op[7] = rl[int(descale(tmp10 - tmp3, sh)) & 1023];
    op[1] = rl[int(descale(tmp11 + tmp2, sh)) & 1023];
    op[6] = rl[int(descale(tmp11 - tmp2, sh)) & 1023];
    op[2] = rl[int(descale(tmp12 + tmp1, sh)) & 1023];
    op[5] = rl[int(descale(tmp12 - tmp1, sh)) & 1023];
    op[3] = rl[int(descale(tmp13 + tmp0, sh)) & 1023];
    op[4] = rl[int(descale(tmp13 - tmp0, sh)) & 1023];
  }
}

// one component's samples: wib*8 x hib*8, real data in width x height
struct Plane {
  int w = 0, h = 0, stride = 0;
  std::vector<uint8_t> px;
  const uint8_t* row(int y) const { return px.data() + size_t(y) * stride; }
};

Plane component_plane(const Component& c) {
  Plane p;
  p.w = c.width;
  p.h = c.height;
  p.stride = c.wib * 8;
  p.px.assign(size_t(p.stride) * size_t(c.hib) * 8, 0);
  for (int by = 0; by < c.hib; ++by)
    for (int bx = 0; bx < c.wib; ++bx)
      idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.quant,
                 p.px.data() + size_t(by) * 8 * p.stride + size_t(bx) * 8, size_t(p.stride));
  return p;
}

// upsample component plane to the full image size (jdsample.c)
std::vector<uint8_t> upsample(const Plane& p, int hx, int vx, int W, int H) {
  std::vector<uint8_t> out(size_t(W) * H);
  if (hx == 1 && vx == 1) {
    for (int y = 0; y < H; ++y) std::memcpy(&out[size_t(y) * W], p.row(y), W);
    return out;
  }
  const int dw = p.w, dh = p.h;
  auto rowc = [&](int y) { return p.row(std::min(std::max(y, 0), dh - 1)); };
  if (hx == 2 && vx == 1 && dw > 2) {  // h2v1_fancy_upsample
    std::vector<uint8_t> line(size_t(2) * dw);
    for (int y = 0; y < H; ++y) {
      const uint8_t* in = p.row(y);
      line[0] = in[0];
      line[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; ++i) {
        int v = in[i] * 3;
        line[2 * i] = uint8_t((v + in[i - 1] + 1) >> 2);
        line[2 * i + 1] = uint8_t((v + in[i + 1] + 2) >> 2);
      }
      line[2 * dw - 2] = uint8_t((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      line[2 * dw - 1] = in[dw - 1];
      std::memcpy(&out[size_t(y) * W], line.data(), W);
    }
    return out;
  }
  if (hx == 2 && vx == 2 && dw > 2) {  // h2v2_fancy_upsample
    std::vector<int> colsum(dw);
    std::vector<uint8_t> line(size_t(2) * dw);
    for (int y = 0; y < H; ++y) {
      int iy = y >> 1;
      const uint8_t* in0 = rowc(iy);
      const uint8_t* in1 = (y & 1) ? rowc(iy + 1) : rowc(iy - 1);
      for (int i = 0; i < dw; ++i) colsum[i] = in0[i] * 3 + in1[i];
      line[0] = uint8_t((colsum[0] * 4 + 8) >> 4);
      line[1] = uint8_t((colsum[0] * 3 + colsum[1] + 7) >> 4);
      for (int i = 1; i < dw - 1; ++i) {
        line[2 * i] = uint8_t((colsum[i] * 3 + colsum[i - 1] + 8) >> 4);
        line[2 * i + 1] = uint8_t((colsum[i] * 3 + colsum[i + 1] + 7) >> 4);
      }
      line[2 * dw - 2] = uint8_t((colsum[dw - 1] * 3 + colsum[dw - 2] + 8) >> 4);
      line[2 * dw - 1] = uint8_t((colsum[dw - 1] * 4 + 7) >> 4);
      std::memcpy(&out[size_t(y) * W], line.data(), W);
    }
    return out;
  }
  if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < H; ++y) {
      int iy = y >> 1;
      const uint8_t* in0 = rowc(iy);
      const uint8_t* in1 = (y & 1) ? rowc(iy + 1) : rowc(iy - 1);
      int bias = (y & 1) ? 2 : 1;
      uint8_t* o = &out[size_t(y) * W];
      for (int i = 0; i < W; ++i) o[i] = uint8_t((in0[i] * 3 + in1[i] + bias) >> 2);
    }
    return out;
  }
  // box replication: h2v1_upsample, h2v2_upsample, int_upsample
  for (int y = 0; y < H; ++y) {
    const uint8_t* in = p.row(y / vx);
    uint8_t* o = &out[size_t(y) * W];
    for (int x = 0; x < W; ++x) o[x] = in[x / hx];
  }
  return out;
}

// jdcolor.c ycc_rgb_convert tables
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// decode a stream whose header dec.read_header() has read
void decode_into(Decoder& dec, uint8_t* out) {
  dec.decode_scans();
  if (dec.block_smoothing_would_apply())
    fail("progressive JPEG whose scans leave low AC coefficients incomplete "
         "(libjpeg would smooth its blocks) is not supported");
  for (auto& c : dec.comps) {
    if (!c.quant_latched) {  // a component that no scan carried stays grey
      if (!dec.qt_present[c.tq]) fail("JPEG quantization table missing");
      std::memcpy(c.quant, dec.qt[c.tq], sizeof(c.quant));
      c.quant_latched = true;
    }
  }
  dec.allocate();
  const int W = dec.width, H = dec.height;
  std::vector<std::vector<uint8_t>> full;
  for (const auto& c : dec.comps) {
    Plane p = component_plane(c);
    full.push_back(upsample(p, dec.max_h / c.h, dec.max_v / c.v, W, H));
  }
  const size_t npx = size_t(W) * H;
  if (dec.comps.size() == 1) {
    std::memcpy(out, full[0].data(), npx);
    return;
  }
  bool ycc;
  if (dec.jfif) ycc = true;
  else if (dec.adobe) ycc = dec.adobe_transform != 0;
  else {
    int c0 = dec.comps[0].id, c1 = dec.comps[1].id, c2 = dec.comps[2].id;
    ycc = !(c0 == 82 && c1 == 71 && c2 == 66);
  }
  const uint8_t* y = full[0].data();
  const uint8_t* cb = full[1].data();
  const uint8_t* cr = full[2].data();
  if (!ycc) {
    for (size_t i = 0; i < npx; ++i) {
      out[3 * i] = y[i];
      out[3 * i + 1] = cb[i];
      out[3 * i + 2] = cr[i];
    }
    return;
  }
  for (size_t i = 0; i < npx; ++i) {
    int Y = y[i], B = cb[i], R = cr[i];
    out[3 * i] = clamp255(Y + kYcc.cr_r[R]);
    out[3 * i + 1] = clamp255(Y + int((kYcc.cb_g[B] + kYcc.cr_g[R]) >> 16));
    out[3 * i + 2] = clamp255(Y + kYcc.cb_b[B]);
  }
}

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

struct EncHuff {
  uint32_t code[256];
  uint8_t size[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    uint32_t c = 0;
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++p) {
        code[vals[p]] = c++;
        size[vals[p]] = uint8_t(l);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>* out;
  uint64_t acc = 0;
  int bits = 0;
  void put(uint32_t v, int n) {
    if (n == 0) return;
    acc = (acc << n) | (v & ((uint32_t(1) << n) - 1));
    bits += n;
    while (bits >= 8) {
      uint8_t b = uint8_t(acc >> (bits - 8));
      out->push_back(b);
      if (b == 0xFF) out->push_back(0);
      bits -= 8;
    }
  }
};

void fdct_islow(int* data) {
  int* p = data;
  for (int r = 0; r < 8; ++r, p += 8) {
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = int((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = int(descale(z1 + tmp13 * FIX_0_765366865, kConstBits - kPass1Bits));
    p[6] = int(descale(z1 + tmp12 * (-FIX_1_847759065), kConstBits - kPass1Bits));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = int(descale(tmp4 + z1 + z3, kConstBits - kPass1Bits));
    p[5] = int(descale(tmp5 + z2 + z4, kConstBits - kPass1Bits));
    p[3] = int(descale(tmp6 + z2 + z3, kConstBits - kPass1Bits));
    p[1] = int(descale(tmp7 + z1 + z4, kConstBits - kPass1Bits));
  }
  for (int c = 0; c < 8; ++c) {
    p = data + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = int(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = int(descale(z1 + tmp13 * FIX_0_765366865, kConstBits + kPass1Bits));
    p[48] = int(descale(z1 + tmp12 * (-FIX_1_847759065), kConstBits + kPass1Bits));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = int(descale(tmp4 + z1 + z3, kConstBits + kPass1Bits));
    p[40] = int(descale(tmp5 + z2 + z4, kConstBits + kPass1Bits));
    p[24] = int(descale(tmp6 + z2 + z3, kConstBits + kPass1Bits));
    p[8] = int(descale(tmp7 + z1 + z4, kConstBits + kPass1Bits));
  }
}

// jcdctmgr.c compute_reciprocal / quantize with 16-bit DCTELEMs
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint64_t fq = (uint64_t(1) << r) / divisor;
  uint64_t fr = (uint64_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return Divisor{uint32_t(fq), c, r};
}

struct Encoder {
  int W, H, nc, quality;
  const uint8_t* px;
  const uint8_t* com = nullptr;
  size_t comlen = 0;
  std::vector<uint8_t> out;
  uint16_t qt[2][64];
  Divisor div[2][64];
  EncHuff dc[2], ac[2];

  void marker(int m) {
    out.push_back(0xFF);
    out.push_back(uint8_t(m));
  }
  void u16(int v) {
    out.push_back(uint8_t(v >> 8));
    out.push_back(uint8_t(v & 0xFF));
  }

  void set_quality() {
    int q = quality;
    if (q <= 0) q = 1;
    if (q > 100) q = 100;
    int scale = q < 50 ? 5000 / q : 200 - q * 2;
    const uint8_t* base[2] = {kStdLumaQuant, kStdChromaQuant};
    for (int t = 0; t < 2; ++t) {
      for (int i = 0; i < 64; ++i) {
        long temp = (long(base[t][i]) * scale + 50L) / 100L;
        if (temp <= 0) temp = 1;
        if (temp > 32767) temp = 32767;
        if (temp > 255) temp = 255;  // force_baseline
        qt[t][i] = uint16_t(temp);
        div[t][i] = reciprocal(uint32_t(temp) << 3);
      }
    }
  }

  void headers() {
    marker(0xD8);
    marker(0xE0);  // JFIF 1.01, no units, 1:1, no thumbnail
    u16(16);
    const uint8_t jfif[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    out.insert(out.end(), jfif, jfif + sizeof(jfif));
    if (comlen) {
      marker(0xFE);
      u16(int(comlen + 2));
      out.insert(out.end(), com, com + comlen);
    }
    int ntables = nc == 3 ? 2 : 1;
    for (int t = 0; t < ntables; ++t) {
      marker(0xDB);
      u16(67);
      out.push_back(uint8_t(t));
      for (int i = 0; i < 64; ++i) out.push_back(uint8_t(qt[t][kNatural[i]]));
    }
    marker(0xC0);
    u16(8 + 3 * nc);
    out.push_back(8);
    u16(H);
    u16(W);
    out.push_back(uint8_t(nc));
    for (int c = 0; c < nc; ++c) {
      out.push_back(uint8_t(c + 1));
      out.push_back(c == 0 && nc == 3 ? 0x22 : 0x11);
      out.push_back(uint8_t(c == 0 ? 0 : 1));
    }
    for (int t = 0; t < ntables; ++t) {
      emit_dht(kDcLumaBits, kDcChromaBits, kDcVals, kDcVals, t, false);
      emit_dht(kAcLumaBits, kAcChromaBits, kAcLumaVals, kAcChromaVals, t, true);
    }
    marker(0xDA);
    u16(6 + 2 * nc);
    out.push_back(uint8_t(nc));
    for (int c = 0; c < nc; ++c) {
      out.push_back(uint8_t(c + 1));
      out.push_back(c == 0 ? 0x00 : 0x11);
    }
    out.push_back(0);
    out.push_back(63);
    out.push_back(0);
  }

  void emit_dht(const uint8_t* b0, const uint8_t* b1, const uint8_t* v0, const uint8_t* v1,
                int t, bool is_ac) {
    const uint8_t* bits = t ? b1 : b0;
    const uint8_t* vals = t ? v1 : v0;
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += bits[l];
    marker(0xC4);
    u16(2 + 1 + 16 + count);
    out.push_back(uint8_t(t + (is_ac ? 0x10 : 0)));
    for (int l = 1; l <= 16; ++l) out.push_back(bits[l]);
    out.insert(out.end(), vals, vals + count);
  }

  // padded component planes as libjpeg's prep + downsample controllers give
  // them: width_in_blocks*8 columns, the iMCU rows' height
  std::vector<uint8_t> planes[3];
  int pw[3], ph[3], wib[3], hib[3], hs[3], vs[3];

  void prepare() {
    const int max_h = nc == 3 ? 2 : 1, max_v = nc == 3 ? 2 : 1;
    const int mcus_x = (W + 8 * max_h - 1) / (8 * max_h);
    const int mcus_y = (H + 8 * max_v - 1) / (8 * max_v);
    std::vector<uint8_t> full[3];
    for (int c = 0; c < nc; ++c) full[c].resize(size_t(W) * H);
    if (nc == 1) {
      std::memcpy(full[0].data(), px, size_t(W) * H);
    } else {
      // jccolor.c rgb_ycc_convert
      const int64_t one_half = int64_t(1) << 15;
      const int64_t cbcr_offset = int64_t(128) << 16;
      auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
      int64_t ry[256], gy[256], by[256], rcb[256], gcb[256], bcb[256], gcr[256], bcr[256];
      for (int i = 0; i < 256; ++i) {
        ry[i] = fix(0.29900) * i;
        gy[i] = fix(0.58700) * i;
        by[i] = fix(0.11400) * i + one_half;
        rcb[i] = -fix(0.16874) * i;
        gcb[i] = -fix(0.33126) * i;
        bcb[i] = fix(0.50000) * i + cbcr_offset + one_half - 1;
        gcr[i] = -fix(0.41869) * i;
        bcr[i] = -fix(0.08131) * i;
      }
      const size_t npx = size_t(W) * H;
      for (size_t i = 0; i < npx; ++i) {
        int r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
        full[0][i] = uint8_t((ry[r] + gy[g] + by[b]) >> 16);
        full[1][i] = uint8_t((rcb[r] + gcb[g] + bcb[b]) >> 16);
        full[2][i] = uint8_t((bcb[r] + gcr[g] + bcr[b]) >> 16);
      }
    }
    // bottom padding of the full-size rows to a multiple of max_v
    const int Hp = (H + max_v - 1) / max_v * max_v;
    for (int c = 0; c < nc; ++c) {
      hs[c] = c == 0 ? max_h : 1;
      vs[c] = c == 0 ? max_v : 1;
      const int cw = int((int64_t(W) * hs[c] + max_h - 1) / max_h);
      const int chh = int((int64_t(H) * vs[c] + max_v - 1) / max_v);
      wib[c] = (cw + 7) / 8;
      hib[c] = (chh + 7) / 8;
      pw[c] = mcus_x * hs[c] * 8;
      ph[c] = mcus_y * vs[c] * 8;
      planes[c].assign(size_t(pw[c]) * ph[c], 0);
      const int outcols = wib[c] * 8;
      const int fx = max_h / hs[c], fy = max_v / vs[c];
      const int incols = outcols * fx;  // expand_right_edge target
      std::vector<uint8_t> row0(incols), row1(incols);
      const int out_rows = Hp / fy;
      for (int oy = 0; oy < out_rows; ++oy) {
        auto fetch = [&](int y, std::vector<uint8_t>& row) {
          const uint8_t* src = &full[c][size_t(std::min(y, H - 1)) * W];
          std::memcpy(row.data(), src, std::min(W, incols));
          for (int x = W; x < incols; ++x) row[x] = src[W - 1];
        };
        uint8_t* dst = &planes[c][size_t(oy) * pw[c]];
        if (fx == 1 && fy == 1) {
          fetch(oy, row0);
          std::memcpy(dst, row0.data(), outcols);
        } else {  // h2v2_downsample, bias 1,2,1,2,...
          fetch(2 * oy, row0);
          fetch(2 * oy + 1, row1);
          int bias = 1;
          for (int ox = 0; ox < outcols; ++ox) {
            dst[ox] = uint8_t((row0[2 * ox] + row0[2 * ox + 1] + row1[2 * ox] +
                               row1[2 * ox + 1] + bias) >> 2);
            bias ^= 3;
          }
        }
      }
      // expand_bottom_edge of the downsampled rows to the iMCU height
      for (int oy = out_rows; oy < ph[c]; ++oy)
        std::memcpy(&planes[c][size_t(oy) * pw[c]], &planes[c][size_t(out_rows - 1) * pw[c]],
                    outcols);
    }
  }

  void forward_block(int c, int bx, int by, int16_t* coef) {
    int data[64];
    const int t = c == 0 ? 0 : 1;
    for (int y = 0; y < 8; ++y) {
      const uint8_t* row = &planes[c][size_t(by * 8 + y) * pw[c] + size_t(bx) * 8];
      for (int x = 0; x < 8; ++x) data[8 * y + x] = int(row[x]) - 128;
    }
    fdct_islow(data);
    for (int i = 0; i < 64; ++i) {
      int temp = data[i];
      const Divisor& dv = div[t][i];
      bool neg = temp < 0;
      if (neg) temp = -temp;
      uint32_t product = uint32_t(uint16_t(temp + int(dv.corr))) * dv.recip;
      product >>= dv.shift;
      int q = int(int16_t(product));
      coef[i] = int16_t(neg ? -q : q);
    }
  }

  void encode_block(BitWriter& bw, const int16_t* coef, int* last_dc, int t) {
    int temp = coef[0] - *last_dc;
    *last_dc = coef[0];
    int temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    int nbits = 0;
    while (temp) {
      ++nbits;
      temp >>= 1;
    }
    bw.put(dc[t].code[nbits], dc[t].size[nbits]);
    if (nbits) bw.put(uint32_t(temp2), nbits);
    int r = 0;
    for (int k = 1; k < 64; ++k) {
      int v = coef[kNatural[k]];
      if (v == 0) {
        ++r;
        continue;
      }
      while (r > 15) {
        bw.put(ac[t].code[0xF0], ac[t].size[0xF0]);
        r -= 16;
      }
      int a = v, a2 = v;
      if (a < 0) {
        a = -a;
        --a2;
      }
      nbits = 1;
      while (a >>= 1) ++nbits;
      int sym = (r << 4) + nbits;
      bw.put(ac[t].code[sym], ac[t].size[sym]);
      bw.put(uint32_t(a2), nbits);
      r = 0;
    }
    if (r > 0) bw.put(ac[t].code[0], ac[t].size[0]);
  }

  void run() {
    set_quality();
    dc[0].build(kDcLumaBits, kDcVals);
    ac[0].build(kAcLumaBits, kAcLumaVals);
    dc[1].build(kDcChromaBits, kDcVals);
    ac[1].build(kAcChromaBits, kAcChromaVals);
    headers();
    prepare();
    const int max_h = nc == 3 ? 2 : 1, max_v = nc == 3 ? 2 : 1;
    const int mcus_x = (W + 8 * max_h - 1) / (8 * max_h);
    const int mcus_y = (H + 8 * max_v - 1) / (8 * max_v);
    BitWriter bw;
    bw.out = &out;
    int last_dc[3] = {0, 0, 0};
    int16_t blocks[10][64];
    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx) {
        int blkn = 0;
        for (int c = 0; c < nc; ++c) {
          for (int yy = 0; yy < vs[c]; ++yy) {
            const int by = my * vs[c] + yy;
            for (int xx = 0; xx < hs[c]; ++xx, ++blkn) {
              const int bx = mx * hs[c] + xx;
              int16_t* blk = blocks[blkn];
              if (by < hib[c] && bx < wib[c]) {
                forward_block(c, bx, by, blk);
              } else {
                // dummy blocks: zero AC, the DC of the block before
                std::memset(blk, 0, sizeof(blocks[0]));
                blk[0] = by < hib[c] ? blocks[blkn - 1][0] : blocks[blkn - xx - 1][0];
              }
            }
          }
        }
        blkn = 0;
        for (int c = 0; c < nc; ++c) {
          const int t = c == 0 ? 0 : 1;
          for (int b = 0; b < hs[c] * vs[c]; ++b) encode_block(bw, blocks[blkn++], &last_dc[c], t);
        }
      }
    }
    if (bw.bits) bw.put(0x7F, 7);
    marker(0xD9);
  }
};

// ---------------------------------------------------------------------------
// MPEG-4 Part 2 video (ISO/IEC 14496-2), Simple Profile, intra-only
// ---------------------------------------------------------------------------
//
// Every frame is an I-VOP at one fixed vop_quant: the H.263 quantizer
// (quant_type 0), intra DC through the dct_dc_size VLCs with DC prediction
// (intra_dc_vlc_thr 0), ac_pred_flag 0 (the plain zigzag), AC through the
// intra TCOEF table and escape type 3 (fixed length) for every (last, run,
// level) outside it; no resync markers, no data partitioning. RGB goes to
// BT.601 limited-range YCbCr 4:2:0 in integer arithmetic (chroma from 2x2
// sums), and the planes are padded to whole macroblocks by replicating the
// last column and row; the VOL carries the true size.

// MSB-first bit writer with no byte stuffing
struct Mp4vBits {
  std::vector<uint8_t>* out;
  uint64_t acc = 0;
  int bits = 0;
  void put(uint32_t v, int n) {
    if (n == 0) return;
    acc = (acc << n) | (v & uint32_t((uint64_t(1) << n) - 1));
    bits += n;
    while (bits >= 8) {
      out->push_back(uint8_t(acc >> (bits - 8)));
      bits -= 8;
    }
  }
  // next_start_code(): a 0, then 1s up to the byte boundary (a whole 0x7F
  // when already aligned)
  void stuff() {
    put(0, 1);
    if (bits) put((1u << (8 - bits)) - 1, 8 - bits);
  }
  void start_code(uint32_t code) {
    put(0, 16);
    put(0x100 | code, 16);
  }
};

// intra TCOEF VLCs (Table B-16): codes and lengths without the sign bit,
// entries ordered by (last, run, level); kMp4vIntraLast0 entries with last 0
const uint16_t kMp4vIntraVlc[102][2] = {
    {0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},  {0x13, 6},
    {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},  {0x25, 9},  {0x24, 9},
    {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10}, {0xf, 10},  {0xe, 10},  {0x7, 11},
    {0x6, 11},  {0x20, 11}, {0x21, 11}, {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},
    {0x14, 6},  {0x16, 7},  {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11},
    {0x53, 12}, {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
    {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},  {0xa, 10},
    {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},  {0x54, 12}, {0x14, 7},
    {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},  {0x18, 8},  {0x23, 11}, {0x17, 8},
    {0x19, 9},  {0x18, 9},  {0x7, 10},  {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},
    {0x17, 9},  {0x6, 10},  {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},
    {0x5, 10},  {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
    {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},  {0x1a, 8},
    {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},  {0x26, 11}, {0x27, 11},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}};
constexpr int kMp4vIntraLast0 = 67;
// the largest level of each run in the table, last 0 then last 1
const uint8_t kMp4vIntraMaxLevel[2][21] = {
    {27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0},
    {8, 3, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1}};
constexpr uint32_t kMp4vEscape = 0x3;  // 0000011
constexpr int kMp4vEscapeLen = 7;
// MCBPC of an intra macroblock (mb_type 3) by cbpc; CBPY of an intra
// macroblock by cbpy (Tables B-6, B-8)
const uint8_t kMp4vMcbpc[4][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}};
const uint8_t kMp4vCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4},
                                  {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4}, {10, 4},
                                  {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// dct_dc_size VLCs, sizes 0..12 (Tables B-13, B-14)
const uint8_t kMp4vDcLuma[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5},
                                    {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const uint8_t kMp4vDcChroma[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4}, {1, 5}, {1, 6},
                                      {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};

// dc_scaler of the H.263 quantizer (Table 7-1)
int mp4v_dc_scaler(int qp, bool luma) {
  if (qp <= 4) return 8;
  if (luma) return qp <= 8 ? 2 * qp : (qp <= 24 ? qp + 8 : 2 * qp - 16);
  return qp <= 24 ? (qp + 13) / 2 : qp - 6;
}

// Simple Profile level by macroblocks per VOP (L1 99, L2-L3 396, L4a 1200,
// L5 1620, L6 3600); past L6 its indication stays, as the highest level
int mp4v_profile_level(int mbs) {
  if (mbs <= 99) return 0x01;
  if (mbs <= 396) return 0x02;
  if (mbs <= 1200) return 0x04;
  if (mbs <= 1620) return 0x05;
  return 0x06;
}

struct Mp4vEncoder {
  int W, H, fps, qp;
  int mbw, mbh, tbits;
  std::vector<uint8_t> out;
  std::vector<uint8_t> planes[3];  // Y (16 mbw x 16 mbh), Cb, Cr (8 mbw x 8 mbh)
  std::vector<int> dc[3];          // reconstructed DC of each block, for prediction
  int tab[2][21][28];              // (last, run, level) -> table index, -1 outside

  void init() {
    mbw = (W + 15) / 16;
    mbh = (H + 15) / 16;
    tbits = 1;
    while ((1 << tbits) < fps) ++tbits;
    for (int c = 0; c < 3; ++c) {
      int s = c == 0 ? 16 : 8;
      planes[c].assign(size_t(s * mbw) * (s * mbh), 0);
      dc[c].assign(size_t(s / 8 * mbw) * (s / 8 * mbh), 0);
    }
    std::memset(tab, -1, sizeof(tab));
    int i = 0;
    for (int last = 0; last < 2; ++last)
      for (int run = 0; run < 21; ++run)
        for (int lv = 1; lv <= kMp4vIntraMaxLevel[last][run]; ++lv) tab[last][run][lv] = i++;
  }

  void header() {
    Mp4vBits b{&out};
    b.start_code(0xB0);  // visual_object_sequence
    b.put(mp4v_profile_level(mbw * mbh), 8);
    b.start_code(0xB5);  // visual_object
    b.put(0, 1);         // is_visual_object_identifier
    b.put(1, 4);         // visual_object_type: video
    b.put(0, 1);         // video_signal_type
    b.stuff();
    b.start_code(0x00);  // video_object 0
    b.start_code(0x20);  // video_object_layer 0
    b.put(0, 1);         // random_accessible_vol
    b.put(1, 8);         // video_object_type_indication: Simple Object
    b.put(0, 1);         // is_object_layer_identifier
    b.put(1, 4);         // aspect_ratio_info: square pixels
    b.put(1, 1);         // vol_control_parameters
    b.put(1, 2);         // chroma_format 4:2:0
    b.put(1, 1);         // low_delay: no B-VOPs
    b.put(0, 1);         // vbv_parameters
    b.put(0, 2);         // video_object_layer_shape: rectangular
    b.put(1, 1);
    b.put(uint32_t(fps), 16);  // vop_time_increment_resolution
    b.put(1, 1);
    b.put(1, 1);               // fixed_vop_rate
    b.put(1, tbits);           // fixed_vop_time_increment: one tick per VOP
    b.put(1, 1);
    b.put(uint32_t(W), 13);
    b.put(1, 1);
    b.put(uint32_t(H), 13);
    b.put(1, 1);
    b.put(0, 1);  // interlaced
    b.put(1, 1);  // obmc_disable
    b.put(0, 1);  // sprite_enable
    b.put(0, 1);  // not_8_bit
    b.put(0, 1);  // quant_type: H.263
    b.put(1, 1);  // complexity_estimation_disable
    b.put(1, 1);  // resync_marker_disable
    b.put(0, 1);  // data_partitioned
    b.put(0, 1);  // scalability
    b.stuff();
  }

  // BT.601 limited range in 16-bit fixed point; chroma from 2x2 sums
  void convert(const uint8_t* rgb) {
    const int PW = 16 * mbw, CW = 8 * mbw, CH = 8 * mbh;
    uint8_t* Y = planes[0].data();
    for (int y = 0; y < H; ++y) {
      const uint8_t* p = rgb + size_t(y) * W * 3;
      uint8_t* row = Y + size_t(y) * PW;
      for (int x = 0; x < W; ++x, p += 3)
        row[x] = uint8_t((16829 * p[0] + 33039 * p[1] + 6416 * p[2] + (16 << 16) + 32768) >> 16);
      for (int x = W; x < PW; ++x) row[x] = row[W - 1];
    }
    for (int y = H; y < 16 * mbh; ++y)
      std::memcpy(Y + size_t(y) * PW, Y + size_t(H - 1) * PW, PW);
    const int cw = W / 2, ch = H / 2;
    uint8_t* U = planes[1].data();
    uint8_t* V = planes[2].data();
    for (int y = 0; y < ch; ++y) {
      const uint8_t* p0 = rgb + size_t(2 * y) * W * 3;
      const uint8_t* p1 = p0 + size_t(W) * 3;
      uint8_t* urow = U + size_t(y) * CW;
      uint8_t* vrow = V + size_t(y) * CW;
      for (int x = 0; x < cw; ++x, p0 += 6, p1 += 6) {
        int r = p0[0] + p0[3] + p1[0] + p1[3];
        int g = p0[1] + p0[4] + p1[1] + p1[4];
        int bl = p0[2] + p0[5] + p1[2] + p1[5];
        // offsets keep the sums positive, so the shifts round half up
        urow[x] = uint8_t((-9714 * r - 19070 * g + 28784 * bl + (128 << 18) + (1 << 17)) >> 18);
        vrow[x] = uint8_t((28784 * r - 24103 * g - 4681 * bl + (128 << 18) + (1 << 17)) >> 18);
      }
      for (int x = cw; x < CW; ++x) {
        urow[x] = urow[cw - 1];
        vrow[x] = vrow[cw - 1];
      }
    }
    for (int y = ch; y < CH; ++y) {
      std::memcpy(U + size_t(y) * CW, U + size_t(ch - 1) * CW, CW);
      std::memcpy(V + size_t(y) * CW, V + size_t(ch - 1) * CW, CW);
    }
  }

  // the block at block coordinates (bx, by) of plane c: quantized
  // coefficients in natural order, the DC quantized by dc_scaler
  void quantize(int c, int bx, int by, int dcs, int* q) {
    const int stride = (c == 0 ? 16 : 8) * mbw;
    int data[64];
    for (int y = 0; y < 8; ++y) {
      const uint8_t* row = &planes[c][size_t(by * 8 + y) * stride + size_t(bx) * 8];
      for (int x = 0; x < 8; ++x) data[8 * y + x] = row[x];  // no level shift
    }
    fdct_islow(data);  // 8 times the DCT of the spec
    q[0] = (data[0] + 4 * dcs) / (8 * dcs);  // the DC is >= 0
    for (int i = 1; i < 64; ++i) {
      int a = data[i] < 0 ? -data[i] : data[i];
      int lv = std::min(((a + 4) >> 3) / (2 * qp), 2047);
      q[i] = data[i] < 0 ? -lv : lv;
    }
  }

  // the DC differential against the gradient-chosen neighbour (7.4.3.1);
  // neighbours outside the VOP count as 1024
  int dc_differential(int c, int bx, int by, int dcs, int qdc) {
    const int bw = (c == 0 ? 2 : 1) * mbw;
    std::vector<int>& d = dc[c];
    int fa = bx > 0 ? d[size_t(by) * bw + bx - 1] : 1024;
    int fb = bx > 0 && by > 0 ? d[size_t(by - 1) * bw + bx - 1] : 1024;
    int fc = by > 0 ? d[size_t(by - 1) * bw + bx] : 1024;
    int fp = std::abs(fa - fb) < std::abs(fb - fc) ? fc : fa;
    d[size_t(by) * bw + bx] = std::min(qdc * dcs, 2047);
    return qdc - (fp + dcs / 2) / dcs;
  }

  void put_dc(Mp4vBits& b, int diff, bool luma) {
    int a = diff < 0 ? -diff : diff, size = 0;
    while (a >> size) ++size;
    const uint8_t* v = luma ? kMp4vDcLuma[size] : kMp4vDcChroma[size];
    b.put(v[0], v[1]);
    if (size == 0) return;
    b.put(uint32_t(diff < 0 ? diff + (1 << size) - 1 : diff), size);
    if (size > 8) b.put(1, 1);  // marker
  }

  void put_ac(Mp4vBits& b, const int* q) {
    int lastpos = 0;
    for (int k = 1; k < 64; ++k)
      if (q[kNatural[k]]) lastpos = k;
    int run = 0;
    for (int k = 1; k <= lastpos; ++k) {
      int v = q[kNatural[k]];
      if (!v) {
        ++run;
        continue;
      }
      int last = k == lastpos, a = v < 0 ? -v : v;
      int i = run <= 20 && a <= 27 ? tab[last][run][a] : -1;
      if (i >= 0) {
        b.put(kMp4vIntraVlc[i][0], kMp4vIntraVlc[i][1]);
        b.put(v < 0, 1);
      } else {  // escape type 3: last, run, marker, 12-bit level, marker
        b.put(kMp4vEscape, kMp4vEscapeLen);
        b.put(3, 2);
        b.put(uint32_t(last), 1);
        b.put(uint32_t(run), 6);
        b.put(1, 1);
        b.put(uint32_t(v) & 0xFFF, 12);
        b.put(1, 1);
      }
      run = 0;
    }
  }

  // one I-VOP for frame `index` (vop_time_increment_resolution = fps,
  // one tick per frame)
  void vop(const uint8_t* rgb, int index) {
    convert(rgb);
    Mp4vBits b{&out};
    b.start_code(0xB6);
    b.put(0, 2);  // vop_coding_type: I
    int secs = index / fps, prev = index > 0 ? (index - 1) / fps : 0;
    for (int s = prev; s < secs; ++s) b.put(1, 1);  // modulo_time_base
    b.put(0, 1);
    b.put(1, 1);
    b.put(uint32_t(index % fps), tbits);  // vop_time_increment
    b.put(1, 1);
    b.put(1, 1);  // vop_coded
    b.put(0, 3);  // intra_dc_vlc_thr: always the DC VLCs
    b.put(uint32_t(qp), 5);
    const int dcs_y = mp4v_dc_scaler(qp, true), dcs_c = mp4v_dc_scaler(qp, false);
    int q[6][64], diff[6];
    for (int my = 0; my < mbh; ++my) {
      for (int mx = 0; mx < mbw; ++mx) {
        int cbp = 0;
        for (int k = 0; k < 6; ++k) {
          int c = k < 4 ? 0 : k - 3;
          int bx = k < 4 ? 2 * mx + (k & 1) : mx, by = k < 4 ? 2 * my + (k >> 1) : my;
          int dcs = k < 4 ? dcs_y : dcs_c;
          quantize(c, bx, by, dcs, q[k]);
          diff[k] = dc_differential(c, bx, by, dcs, q[k][0]);
          for (int i = 1; i < 64; ++i)
            if (q[k][i]) {
              cbp |= 1 << (5 - k);
              break;
            }
        }
        b.put(kMp4vMcbpc[cbp & 3][0], kMp4vMcbpc[cbp & 3][1]);  // mb_type 3
        b.put(0, 1);                                           // ac_pred_flag
        b.put(kMp4vCbpy[cbp >> 2][0], kMp4vCbpy[cbp >> 2][1]);
        for (int k = 0; k < 6; ++k) {
          put_dc(b, diff[k], k < 4);
          if (cbp & (1 << (5 - k))) put_ac(b, q[k]);
        }
      }
    }
    b.stuff();
  }
};

void set_err(char* err, size_t errlen, const std::string& msg) {
  if (!err || errlen == 0) return;
  size_t k = std::min(errlen - 1, msg.size());
  std::memcpy(err, msg.data(), k);
  err[k] = 0;
}

}  // namespace

extern "C" {

int gm_jpeg_info(const uint8_t* data, size_t n, int* info, char* err, size_t errlen) {
  try {
    Decoder dec(data, n);
    dec.read_header();
    info[0] = dec.width;
    info[1] = dec.height;
    info[2] = int(dec.comps.size());
    return 0;
  } catch (const CodecError& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
  }
  return 1;
}

int gm_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, size_t cap, char* err,
                   size_t errlen) {
  try {
    Decoder dec(data, n);
    dec.read_header();
    if (size_t(dec.width) * dec.height * dec.comps.size() != cap)
      fail("output buffer does not match the image");
    decode_into(dec, out);
    return 0;
  } catch (const CodecError& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
  }
  return 1;
}

int gm_jpeg_encode(const uint8_t* px, int w, int h, int c, int quality, const uint8_t* com,
                   size_t comlen, uint8_t** out, size_t* outlen, char* err, size_t errlen) {
  try {
    if (w < 1 || h < 1 || w > 65500 || h > 65500) fail("JPEG sizes are 1..65500");
    if (comlen > 65533) fail("JPEG comment longer than 65533 bytes");
    if (c != 1 && c != 3) fail("write_jpeg takes L or RGB");
    Encoder enc;
    enc.W = w;
    enc.H = h;
    enc.nc = c;
    enc.quality = quality;
    enc.px = px;
    enc.com = com;
    enc.comlen = comlen;
    enc.run();
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(enc.out.size()));
    if (!buf) fail("out of memory");
    std::memcpy(buf, enc.out.data(), enc.out.size());
    *out = buf;
    *outlen = enc.out.size();
    return 0;
  } catch (const CodecError& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
  }
  return 1;
}

// MPEG-4 Part 2 video: n RGB frames of w x h (even) into the VOS + VO + VOL
// headers and one I-VOP per frame, concatenated in one buffer (free with
// gm_free); lens[0] is the headers' length, lens[1 + i] frame i's
int gm_mp4v_encode(const uint8_t* rgb, int n, int w, int h, int fps, int quant,
                   uint8_t** out, size_t* outlen, size_t* lens, char* err, size_t errlen) {
  try {
    if (n < 1) fail("no frames to encode");
    if (w < 2 || h < 2 || w > 8190 || h > 8190 || (w | h) & 1)
      fail("MPEG-4 frame sizes are even, 2..8190");
    if (fps < 1 || fps > 65535) fail("MPEG-4 frame rates are whole numbers 1..65535");
    if (quant < 1 || quant > 31) fail("vop_quant is 1..31");
    Mp4vEncoder enc;
    enc.W = w;
    enc.H = h;
    enc.fps = fps;
    enc.qp = quant;
    enc.init();
    enc.header();
    lens[0] = enc.out.size();
    const size_t frame = size_t(w) * h * 3;
    for (int i = 0; i < n; ++i) {
      size_t before = enc.out.size();
      enc.vop(rgb + frame * i, i);
      lens[1 + i] = enc.out.size() - before;
    }
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(enc.out.size()));
    if (!buf) fail("out of memory");
    std::memcpy(buf, enc.out.data(), enc.out.size());
    *out = buf;
    *outlen = enc.out.size();
    return 0;
  } catch (const CodecError& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
  }
  return 1;
}

void gm_free(void* p) { std::free(p); }

// PNG: undo the five row filters in one pass; raw holds h rows of
// 1 + stride bytes, out h rows of stride bytes
int gm_png_unfilter(const uint8_t* raw, int h, size_t stride, int bpp, uint8_t* out,
                    char* err, size_t errlen) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    const uint8_t* line = raw + size_t(y) * (stride + 1);
    uint8_t* cur = out + size_t(y) * stride;
    int f = line[0];
    ++line;
    switch (f) {
      case 0:
        std::memcpy(cur, line, stride);
        break;
      case 1:
        for (size_t i = 0; i < stride; ++i)
          cur[i] = uint8_t(line[i] + (i >= size_t(bpp) ? cur[i - bpp] : 0));
        break;
      case 2:
        for (size_t i = 0; i < stride; ++i) cur[i] = uint8_t(line[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          cur[i] = uint8_t(line[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= size_t(bpp)) ? prev[i - bpp] : 0;
          int p = a + b - c;
          int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = uint8_t(line[i] + pred);
        }
        break;
      default:
        set_err(err, errlen, "bad PNG filter type " + std::to_string(f));
        return 1;
    }
    prev = cur;
  }
  return 0;
}

// out[o, i, c] = clip8((2^21 + sum_j in[o, taps[i, j], c] * w[i, j]) >> 22)
void gm_resample_u8(const uint8_t* in, int64_t outer, int64_t len, int64_t inner,
                    int64_t out_len, int k, const int32_t* taps, const int32_t* w,
                    uint8_t* out) {
  const int bits = 22;
  std::vector<int32_t> acc(static_cast<size_t>(inner));
  for (int64_t o = 0; o < outer; ++o) {
    const uint8_t* src = in + o * len * inner;
    uint8_t* dst = out + o * out_len * inner;
    for (int64_t i = 0; i < out_len; ++i) {
      std::fill(acc.begin(), acc.end(), int32_t(1) << (bits - 1));
      for (int j = 0; j < k; ++j) {
        const int32_t wt = w[i * k + j];
        if (wt == 0) continue;
        const uint8_t* row = src + int64_t(taps[i * k + j]) * inner;
        for (int64_t c = 0; c < inner; ++c) acc[c] += int32_t(row[c]) * wt;
      }
      uint8_t* d = dst + i * inner;
      for (int64_t c = 0; c < inner; ++c) {
        int32_t v = acc[c] >> bits;
        d[c] = uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
      }
    }
  }
}

}  // extern "C"
