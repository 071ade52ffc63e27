// RIFF/WAVE decoder of the corpus packer (data/corpus.py::build_corpus),
// the port's copy of the reference's native wav decoder, with its C ABI.
//
// Each file is decoded to int16 mono, center-cropped or zero-padded to
// store_len, with the arithmetic of the numpy codec (data/wavio.py plus
// build_corpus's scaling), so the two give the same bytes: each sample is
// converted to float32 ((float) x / 32768 for 16-bit PCM, / 2^31 for
// 32-bit, (u - 128) / 128 for 8-bit, IEEE float32 as it is); channels are
// averaged in float32 with numpy's pairwise summation order and one float32
// divide; then x * 32768 in float32, rounded half to even, clipped to int16
// (NaN gives 0). Formats outside PCM 8/16/32-bit and float32 (24-bit PCM,
// an EXTENSIBLE fmt without its SubFormat, a data chunk cut short or not a
// whole number of samples, a short fmt chunk) are reported unsupported, and
// the caller decodes that file with the numpy codec.
//
// Built with g++ into a shared library (kernels/_build.py::build_host) and
// loaded with ctypes (data/native.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kErrNotRiff = -1;
constexpr int kErrNoFmt = -2;
constexpr int kErrUnsupported = -3;
constexpr int kErrTruncated = -4;

uint32_t u32(const uint8_t* q) {
    return static_cast<uint32_t>(q[0]) | (static_cast<uint32_t>(q[1]) << 8) |
           (static_cast<uint32_t>(q[2]) << 16) |
           (static_cast<uint32_t>(q[3]) << 24);
}

uint16_t u16(const uint8_t* q) {
    return static_cast<uint16_t>(q[0] | (q[1] << 8));
}

float sample(const uint8_t* s, uint16_t fmt, uint16_t bits) {
    if (fmt == 3) {
        float x;
        std::memcpy(&x, s, 4);
        return x;
    }
    if (bits == 16) {
        int16_t x;
        std::memcpy(&x, s, 2);
        return static_cast<float>(x) / 32768.0f;
    }
    if (bits == 32) {
        int32_t x;
        std::memcpy(&x, s, 4);
        return static_cast<float>(x) / 2147483648.0f;
    }
    return (static_cast<float>(*s) - 128.0f) / 128.0f;
}

// numpy's pairwise_sum of the n float32 values a[0, n): below 8
// a plain sum from 0; up to 128 eight partial sums combined as a tree, then
// the tail; above, the two halves (the first a multiple of 8) recursively
float pairwise(const float* a, int64_t n) {
    if (n < 8) {
        float r = 0.0f;
        for (int64_t i = 0; i < n; ++i) r += a[i];
        return r;
    }
    if (n <= 128) {
        float r[8];
        for (int j = 0; j < 8; ++j) r[j] = a[j];
        int64_t i = 8;
        for (; i + 8 <= n; i += 8)
            for (int j = 0; j < 8; ++j) r[j] += a[i + j];
        float res = ((r[0] + r[1]) + (r[2] + r[3])) +
                    ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; ++i) res += a[i];
        return res;
    }
    int64_t n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise(a, n2) + pairwise(a + n2, n - n2);
}

int16_t to_int16(float x) {
    float v = std::nearbyint(x * 32768.0f);   // half to even
    if (std::isnan(v)) return 0;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    return static_cast<int16_t>(v);
}

}  // namespace

extern "C" {

// Decodes the wav bytes data[0, size) into out[0, store_len) and its rate
// into *rate_out. Returns the file's frame count (>= 0), or a negative
// code: -1 not RIFF/WAVE, -2 no fmt or data chunk, -3 unsupported format,
// -4 a data chunk cut short.
int64_t ag_decode_wav_to_store(const uint8_t* data, int64_t size,
                               int16_t* out, int64_t store_len,
                               int32_t* rate_out) {
    if (size < 12 || std::memcmp(data, "RIFF", 4) != 0 ||
        std::memcmp(data + 8, "WAVE", 4) != 0) {
        return kErrNotRiff;
    }
    uint16_t fmt = 0, n_ch = 0, bits = 0;
    uint32_t rate = 0;
    const uint8_t* raw = nullptr;
    int64_t raw_len = 0;
    bool have_fmt = false;
    int64_t pos = 12;
    while (pos + 8 <= size) {
        const uint8_t* hdr = data + pos;
        const uint64_t chunk = u32(hdr + 4);
        const uint8_t* body = hdr + 8;
        const bool is_fmt = std::memcmp(hdr, "fmt ", 4) == 0;
        const bool is_data = std::memcmp(hdr, "data", 4) == 0;
        if (static_cast<uint64_t>(pos) + 8 + chunk >
                static_cast<uint64_t>(size)) {
            if (is_data || is_fmt) return kErrTruncated;
            break;
        }
        if (is_fmt) {
            if (chunk < 16) return kErrUnsupported;
            fmt = u16(body);
            n_ch = u16(body + 2);
            rate = u32(body + 4);
            bits = u16(body + 14);
            if (fmt == 0xFFFE) {
                // WAVE_FORMAT_EXTENSIBLE: the format code is the first 2
                // bytes of the SubFormat GUID (16 base + cbSize 2 +
                // validBits 2 + channelMask 4)
                if (chunk < 26) return kErrUnsupported;
                fmt = u16(body + 24);
            }
            have_fmt = true;
        } else if (is_data) {
            raw = body;
            raw_len = static_cast<int64_t>(chunk);
        }
        pos += 8 + static_cast<int64_t>(chunk) + (chunk & 1);
    }
    if (!have_fmt || raw == nullptr) return kErrNoFmt;
    const bool supported = (fmt == 1 && (bits == 8 || bits == 16 ||
                                         bits == 32)) ||
                           (fmt == 3 && bits == 32);
    if (!supported || n_ch == 0) return kErrUnsupported;
    const int64_t bytes_per = bits / 8;
    if (raw_len % bytes_per != 0) return kErrUnsupported;
    *rate_out = static_cast<int32_t>(rate);

    const int64_t frames = raw_len / (bytes_per * n_ch);
    const int64_t off = frames > store_len ? (frames - store_len) / 2 : 0;
    const int64_t count = frames - off < store_len ? frames - off : store_len;
    std::vector<float> ch(n_ch);
    for (int64_t i = 0; i < count; ++i) {
        const uint8_t* f = raw + (off + i) * bytes_per * n_ch;
        float x;
        if (n_ch == 1) {
            x = sample(f, fmt, bits);
        } else {
            for (int c = 0; c < n_ch; ++c)
                ch[c] = sample(f + c * bytes_per, fmt, bits);
            x = pairwise(ch.data(), n_ch) / static_cast<float>(n_ch);
        }
        out[i] = to_int16(x);
    }
    for (int64_t i = count; i < store_len; ++i) out[i] = 0;
    return frames;
}

int32_t ag_abi_version() { return 1; }

}  // extern "C"
