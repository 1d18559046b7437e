// Native host-side codecs for tinyrenderder_tpu.
//
// The reference implements its whole runtime in C++; in this framework
// the device compute path is XLA/Pallas, and these are the
// host-side hot loops kept native: the TGA RLE codec (semantics of the
// reference tgaimage.cpp:124-157 decode and tgaimage.cpp:193-242 greedy
// encode, byte-identical output) exposed with a C ABI for ctypes.
//
// Build: make -C native   (produces libtinyrenderder_native.so)

#include <cstdint>
#include <cstring>

extern "C" {

// Decode RLE pixel data. Returns number of pixels produced, or -1 on
// malformed input. `raw` is the byte stream after the TGA header,
// `out` has room for `npixels * bpp` bytes.
long long trd_rle_decode(const char* raw, long long raw_len,
                         std::uint8_t* out, long long npixels, int bpp) {
    long long pos = 0;
    long long pixel = 0;
    while (pixel < npixels) {
        if (pos >= raw_len) return pixel;  // truncated stream
        const std::uint8_t header = static_cast<std::uint8_t>(raw[pos++]);
        if (header < 128) {               // raw packet: header+1 literal pixels
            const long long count = header + 1;
            const long long nbytes = count * bpp;
            if (pos + nbytes > raw_len) return -1;
            const long long take = (pixel + count <= npixels) ? count
                                                              : npixels - pixel;
            std::memcpy(out + pixel * bpp, raw + pos, take * bpp);
            pos += nbytes;
            pixel += count;
        } else {                          // run packet: header-127 copies
            const long long count = header - 127;
            if (pos + bpp > raw_len) return -1;
            for (long long i = 0; i < count && pixel + i < npixels; ++i)
                std::memcpy(out + (pixel + i) * bpp, raw + pos, bpp);
            pos += bpp;
            pixel += count;
        }
    }
    return pixel > npixels ? npixels : pixel;
}

static inline bool px_eq(const std::uint8_t* a, const std::uint8_t* b, int bpp) {
    for (int i = 0; i < bpp; ++i)
        if (a[i] != b[i]) return false;
    return true;
}

// Greedy RLE encode, byte-identical to the reference encoder
// (tgaimage.cpp:193-242): runs of >= 2 equal pixels become RLE chunks;
// otherwise a raw chunk extends until the next two pixels are equal.
// Returns bytes written, or -1 if `cap` is too small.
long long trd_rle_encode(const std::uint8_t* flat, long long npixels, int bpp,
                         std::uint8_t* out, long long cap) {
    const int max_chunk = 128;
    long long cur = 0;
    long long w = 0;
    while (cur < npixels) {
        const std::uint8_t* base = flat + cur * bpp;
        long long run = 1;
        while (cur + run < npixels && run < max_chunk &&
               px_eq(flat + (cur + run) * bpp, base, bpp))
            ++run;
        if (run > 1) {
            if (w + 1 + bpp > cap) return -1;
            out[w++] = static_cast<std::uint8_t>(run - 1 + 128);
            std::memcpy(out + w, base, bpp);
            w += bpp;
            cur += run;
        } else {
            long long raw_len = 1;
            while (cur + raw_len < npixels && raw_len < max_chunk &&
                   !px_eq(flat + (cur + raw_len) * bpp,
                          flat + (cur + raw_len - 1) * bpp, bpp))
                ++raw_len;
            if (w + 1 + raw_len * bpp > cap) return -1;
            out[w++] = static_cast<std::uint8_t>(raw_len - 1);
            std::memcpy(out + w, flat + cur * bpp, raw_len * bpp);
            w += raw_len * bpp;
            cur += raw_len;
        }
    }
    return w;
}

}  // extern "C"
