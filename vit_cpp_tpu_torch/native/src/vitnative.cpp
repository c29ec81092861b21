// vitnative: host-side native runtime for vit_cpp_tpu (the PyTorch port's
// own copy of vit_cpp_tpu/native/src/vitnative.cpp).
//
// TPU-native replacement for the reference's stb_image decode path
// (load_image_from_file, vit.cpp:109-127). At the 5k images/sec/chip
// serving target JPEG decode dominates host cost (SURVEY.md §7 "Host
// preprocessing throughput"), so decoding is native C++ over libjpeg /
// libpng with a std::thread worker pool for batch decode; resize +
// normalize stay on the TPU (ops/preprocess.py resampling matmuls).
//
// C ABI (consumed via ctypes from vit_cpp_tpu_torch/native/decoder.py):
//   vn_decode_file(path, &w, &h)        -> malloc'd RGB8 buffer or NULL
//   vn_decode_mem(buf, len, &w, &h)     -> same, from an in-memory file
//   vn_decode_batch(paths, n, threads, outs, ws, hs) -> #succeeded;
//       outs[i] == NULL marks a failed decode (harness-style skip,
//       tests/benchmark.cpp:108-125)
//   vn_free(p)                          -> free a returned buffer
//   vn_version()                        -> ABI version int
//
// Output layout matches the reference contract: interleaved HWC RGB,
// 3 channels forced regardless of source colorspace (stbi_load(...,3)).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

extern "C" {

#define VN_ABI_VERSION 1

int vn_version() { return VN_ABI_VERSION; }

void vn_free(uint8_t *p) { std::free(p); }

// ---------------------------------------------------------------- JPEG ----

namespace {

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr *err = reinterpret_cast<JpegErr *>(cinfo->err);
    longjmp(err->jmp, 1);
}

void jpeg_silent(j_common_ptr, int) {}
void jpeg_silent_msg(j_common_ptr) {}

uint8_t *decode_jpeg(const uint8_t *buf, size_t len, int *w, int *h) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    jerr.mgr.emit_message = jpeg_silent;
    jerr.mgr.output_message = jpeg_silent_msg;

    // `out` is written between setjmp and a potential longjmp (the malloc
    // below) and read in the recovery branch; it must be volatile or its
    // value after longjmp is indeterminate (C11 7.13.2.1) — under -O3 the
    // free() could see a stale register copy on a mid-scanline error.
    uint8_t *volatile out = nullptr;
    if (setjmp(jerr.jmp)) {
        std::free(out);
        jpeg_destroy_decompress(&cinfo);
        return nullptr;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t *>(buf),
                 static_cast<unsigned long>(len));
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return nullptr;
    }
    // Force RGB regardless of the source colorspace (grayscale, YCbCr,
    // CMYK via libjpeg's converters) — the stbi_load(..., 3) contract.
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);

    const int width = static_cast<int>(cinfo.output_width);
    const int height = static_cast<int>(cinfo.output_height);
    const int comps = cinfo.output_components;  // 3 after JCS_RGB
    if (comps != 3) {
        jpeg_destroy_decompress(&cinfo);
        return nullptr;
    }
    out = static_cast<uint8_t *>(
        std::malloc(static_cast<size_t>(width) * height * 3));
    if (!out) {
        jpeg_destroy_decompress(&cinfo);
        return nullptr;
    }
    const size_t stride = static_cast<size_t>(width) * 3;
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t *row = out + stride * cinfo.output_scanline;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    *w = width;
    *h = height;
    return out;
}

// ----------------------------------------------------------------- PNG ----

struct PngReadState {
    const uint8_t *data;
    size_t len;
    size_t pos;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
    PngReadState *st =
        static_cast<PngReadState *>(png_get_io_ptr(png));
    if (st->pos + n > st->len) {
        png_error(png, "read past end");
        return;
    }
    std::memcpy(out, st->data + st->pos, n);
    st->pos += n;
}

uint8_t *decode_png(const uint8_t *buf, size_t len, int *w, int *h) {
    if (len < 8 || png_sig_cmp(buf, 0, 8) != 0) return nullptr;
    png_structp png =
        png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    if (!png) return nullptr;
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_read_struct(&png, nullptr, nullptr);
        return nullptr;
    }
    // Same setjmp rule as decode_jpeg: both buffers are allocated after
    // setjmp and freed in the recovery branch, so the pointers must be
    // volatile (a std::vector would have indeterminate internals after
    // longjmp — use a plain malloc'd row-pointer array instead).
    uint8_t *volatile out = nullptr;
    png_bytep *volatile rows = nullptr;
    if (setjmp(png_jmpbuf(png))) {
        std::free(out);
        std::free(rows);
        png_destroy_read_struct(&png, &info, nullptr);
        return nullptr;
    }
    PngReadState st{buf, len, 0};
    png_set_read_fn(png, &st, png_mem_read);
    png_read_info(png, info);

    // Normalize every PNG variant to 8-bit RGB: palette -> RGB, gray ->
    // 8-bit gray -> RGB, 16-bit -> 8-bit, alpha/tRNS stripped.
    png_byte color = png_get_color_type(png, info);
    png_byte depth = png_get_bit_depth(png, info);
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
        png_set_expand_gray_1_2_4_to_8(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    if (depth == 16) png_set_strip_16(png);
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
        png_set_gray_to_rgb(png);
    png_set_strip_alpha(png);
    png_read_update_info(png, info);

    const int width = static_cast<int>(png_get_image_width(png, info));
    const int height = static_cast<int>(png_get_image_height(png, info));
    if (png_get_rowbytes(png, info) != static_cast<size_t>(width) * 3) {
        png_destroy_read_struct(&png, &info, nullptr);
        return nullptr;
    }
    out = static_cast<uint8_t *>(
        std::malloc(static_cast<size_t>(width) * height * 3));
    if (!out) {
        png_destroy_read_struct(&png, &info, nullptr);
        return nullptr;
    }
    rows = static_cast<png_bytep *>(
        std::malloc(sizeof(png_bytep) * static_cast<size_t>(height)));
    if (!rows) {
        std::free(out);
        png_destroy_read_struct(&png, &info, nullptr);
        return nullptr;
    }
    for (int y = 0; y < height; ++y)
        rows[y] = out + static_cast<size_t>(width) * 3 * y;
    png_read_image(png, rows);
    png_read_end(png, nullptr);
    uint8_t *result = out;
    std::free(rows);
    png_destroy_read_struct(&png, &info, nullptr);
    *w = width;
    *h = height;
    return result;
}

// ----------------------------------------------------------------- BMP ----
// Uncompressed 24/32-bit BI_RGB bitmaps (the overwhelmingly common case the
// reference's stb_image path accepts, vit.h:5). Bottom-up and top-down rows.

uint8_t *decode_bmp(const uint8_t *buf, size_t len, int *w, int *h) {
    auto rd32 = [&](size_t off) -> uint32_t {
        return static_cast<uint32_t>(buf[off]) |
               (static_cast<uint32_t>(buf[off + 1]) << 8) |
               (static_cast<uint32_t>(buf[off + 2]) << 16) |
               (static_cast<uint32_t>(buf[off + 3]) << 24);
    };
    auto rd16 = [&](size_t off) -> uint16_t {
        return static_cast<uint16_t>(buf[off]) |
               (static_cast<uint16_t>(buf[off + 1]) << 8);
    };
    if (len < 54 || buf[0] != 'B' || buf[1] != 'M') return nullptr;
    const uint32_t data_off = rd32(10);
    const uint32_t hdr_size = rd32(14);
    if (hdr_size < 40) return nullptr;  // BITMAPINFOHEADER+
    const int32_t width = static_cast<int32_t>(rd32(18));
    const int32_t height_raw = static_cast<int32_t>(rd32(22));
    const uint16_t bpp = rd16(28);
    const uint32_t compression = rd32(30);
    if (width <= 0 || height_raw == 0) return nullptr;
    if (compression != 0 || (bpp != 24 && bpp != 32)) return nullptr;
    const bool top_down = height_raw < 0;
    const int height = top_down ? -height_raw : height_raw;
    const size_t src_stride = ((static_cast<size_t>(width) * bpp / 8) + 3) & ~size_t(3);
    if (data_off + src_stride * height > len) return nullptr;
    uint8_t *out = static_cast<uint8_t *>(
        std::malloc(static_cast<size_t>(width) * height * 3));
    if (!out) return nullptr;
    const int bytes = bpp / 8;
    for (int y = 0; y < height; ++y) {
        const uint8_t *src =
            buf + data_off + src_stride * (top_down ? y : height - 1 - y);
        uint8_t *dst = out + static_cast<size_t>(width) * 3 * y;
        for (int x = 0; x < width; ++x) {
            dst[3 * x + 0] = src[bytes * x + 2];  // BGR(A) -> RGB
            dst[3 * x + 1] = src[bytes * x + 1];
            dst[3 * x + 2] = src[bytes * x + 0];
        }
    }
    *w = width;
    *h = height;
    return out;
}

// ----------------------------------------------------------------- PNM ----
// Binary P5 (gray) / P6 (RGB) portable anymaps, maxval <= 255.

uint8_t *decode_pnm(const uint8_t *buf, size_t len, int *w, int *h) {
    if (len < 2 || buf[0] != 'P' || (buf[1] != '5' && buf[1] != '6'))
        return nullptr;
    const bool rgb = buf[1] == '6';
    size_t pos = 2;
    auto next_int = [&](long *out_val) -> bool {
        // skip whitespace and '#' comments
        for (;;) {
            while (pos < len && (buf[pos] == ' ' || buf[pos] == '\t' ||
                                 buf[pos] == '\n' || buf[pos] == '\r'))
                ++pos;
            if (pos < len && buf[pos] == '#') {
                while (pos < len && buf[pos] != '\n') ++pos;
            } else {
                break;
            }
        }
        long v = 0;
        bool any = false;
        while (pos < len && buf[pos] >= '0' && buf[pos] <= '9') {
            v = v * 10 + (buf[pos] - '0');
            ++pos;
            any = true;
        }
        *out_val = v;
        return any;
    };
    long width, height, maxval;
    if (!next_int(&width) || !next_int(&height) || !next_int(&maxval))
        return nullptr;
    if (width <= 0 || height <= 0 || maxval <= 0 || maxval > 255)
        return nullptr;
    ++pos;  // single whitespace after maxval
    const size_t npix = static_cast<size_t>(width) * height;
    const size_t need = npix * (rgb ? 3 : 1);
    if (pos + need > len) return nullptr;
    uint8_t *out = static_cast<uint8_t *>(std::malloc(npix * 3));
    if (!out) return nullptr;
    const uint8_t *src = buf + pos;
    if (rgb) {
        std::memcpy(out, src, npix * 3);
    } else {
        for (size_t i = 0; i < npix; ++i) {
            out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = src[i];
        }
    }
    *w = static_cast<int>(width);
    *h = static_cast<int>(height);
    return out;
}

// Dimension sanity cap for the hand-rolled decoders: RLE/LZW formats can
// claim arbitrary dimensions in a tiny file, and the output allocation
// happens before the data runs out — cap total pixels (2^26 ~= 8k x 8k)
// so a lying header cannot demand gigabytes or make a vector reserve
// throw through the C ABI.
constexpr size_t VN_MAX_PIXELS = size_t(1) << 26;

// ----------------------------------------------------------------- TGA ----
// Truecolor (2) / grayscale (3) and their RLE variants (10/11), 8/24/32
// bpp, optional colormap skipped for the unmapped types. TGA has no magic;
// the dispatcher calls this last, and the header fields are validated
// strictly so arbitrary bytes fail cleanly (stb accepts TGA via the same
// try-last heuristic, vit.h:5 -> stb_image.h).

uint8_t *decode_tga(const uint8_t *buf, size_t len, int *w, int *h) {
    if (len < 18) return nullptr;
    const uint8_t id_len = buf[0];
    const uint8_t cmap_type = buf[1];
    const uint8_t img_type = buf[2];
    if (cmap_type > 1) return nullptr;
    const bool rle = img_type == 10 || img_type == 11;
    const bool gray = img_type == 3 || img_type == 11;
    if (img_type != 2 && img_type != 3 && img_type != 10 && img_type != 11)
        return nullptr;  // colormapped (1/9) not supported
    const int width = buf[12] | (buf[13] << 8);
    const int height = buf[14] | (buf[15] << 8);
    const uint8_t bpp = buf[16];
    const bool top_down = (buf[17] & 0x20) != 0;
    if (width <= 0 || height <= 0 ||
        static_cast<size_t>(width) * height > VN_MAX_PIXELS)
        return nullptr;
    if (gray ? bpp != 8 : (bpp != 24 && bpp != 32)) return nullptr;
    const int bytes = bpp / 8;
    // skip id field + (unused) colormap spec's table
    const uint16_t cmap_len = static_cast<uint16_t>(buf[5] | (buf[6] << 8));
    const uint8_t cmap_bpp = buf[7];
    size_t pos = 18 + id_len +
                 (cmap_type ? static_cast<size_t>(cmap_len) * ((cmap_bpp + 7) / 8)
                            : 0);
    const size_t npix = static_cast<size_t>(width) * height;
    uint8_t *out = static_cast<uint8_t *>(std::malloc(npix * 3));
    if (!out) return nullptr;
    auto put = [&](size_t i, const uint8_t *px) {
        uint8_t *dst = out + 3 * i;
        if (gray) {
            dst[0] = dst[1] = dst[2] = px[0];
        } else {  // BGR(A) -> RGB
            dst[0] = px[2];
            dst[1] = px[1];
            dst[2] = px[0];
        }
    };
    if (!rle) {
        if (pos + npix * bytes > len) { std::free(out); return nullptr; }
        for (size_t i = 0; i < npix; ++i) put(i, buf + pos + i * bytes);
    } else {
        size_t i = 0;
        while (i < npix) {
            if (pos >= len) { std::free(out); return nullptr; }
            const uint8_t packet = buf[pos++];
            const size_t count = (packet & 0x7F) + 1;
            if (i + count > npix) { std::free(out); return nullptr; }
            if (packet & 0x80) {  // run: one pixel repeated
                if (pos + bytes > len) { std::free(out); return nullptr; }
                for (size_t k = 0; k < count; ++k) put(i + k, buf + pos);
                pos += bytes;
            } else {  // literal pixels
                if (pos + count * bytes > len) { std::free(out); return nullptr; }
                for (size_t k = 0; k < count; ++k)
                    put(i + k, buf + pos + k * bytes);
                pos += count * bytes;
            }
            i += count;
        }
    }
    if (!top_down) {  // flip rows in place (TGA default is bottom-up)
        const size_t stride = static_cast<size_t>(width) * 3;
        std::vector<uint8_t> tmp(stride);
        for (int y = 0; y < height / 2; ++y) {
            uint8_t *a = out + stride * y;
            uint8_t *b = out + stride * (height - 1 - y);
            std::memcpy(tmp.data(), a, stride);
            std::memcpy(a, b, stride);
            std::memcpy(b, tmp.data(), stride);
        }
    }
    *w = width;
    *h = height;
    return out;
}

// ----------------------------------------------------------------- GIF ----
// First frame of GIF87a/89a: global/local color tables, LZW, interlace.
// Transparency composites as opaque (classification input; matches what a
// first-frame stbi_load of an opaque GIF yields).

uint8_t *decode_gif(const uint8_t *buf, size_t len, int *w, int *h) {
    if (len < 13 || std::memcmp(buf, "GIF8", 4) != 0) return nullptr;
    const int sw = buf[6] | (buf[7] << 8);
    const int sh = buf[8] | (buf[9] << 8);
    if (sw <= 0 || sh <= 0 ||
        static_cast<size_t>(sw) * sh > VN_MAX_PIXELS)
        return nullptr;
    size_t pos = 13;
    const uint8_t gflags = buf[10];
    const uint8_t *gct = nullptr;
    int gct_n = 0;
    if (gflags & 0x80) {
        gct_n = 2 << (gflags & 7);
        if (pos + 3 * static_cast<size_t>(gct_n) > len) return nullptr;
        gct = buf + pos;
        pos += 3 * static_cast<size_t>(gct_n);
    }
    // walk blocks to the first image descriptor
    while (pos < len && buf[pos] == 0x21) {  // extension: skip sub-blocks
        pos += 2;
        while (pos < len && buf[pos] != 0) {
            pos += 1 + buf[pos];
            if (pos > len) return nullptr;
        }
        ++pos;
    }
    if (pos + 10 > len || buf[pos] != 0x2C) return nullptr;
    const int ix = buf[pos + 1] | (buf[pos + 2] << 8);
    const int iy = buf[pos + 3] | (buf[pos + 4] << 8);
    const int iw = buf[pos + 5] | (buf[pos + 6] << 8);
    const int ih = buf[pos + 7] | (buf[pos + 8] << 8);
    const uint8_t iflags = buf[pos + 9];
    pos += 10;
    if (iw <= 0 || ih <= 0 || ix + iw > sw || iy + ih > sh) return nullptr;
    const uint8_t *ct = gct;
    int ct_n = gct_n;
    if (iflags & 0x80) {  // local color table
        ct_n = 2 << (iflags & 7);
        if (pos + 3 * static_cast<size_t>(ct_n) > len) return nullptr;
        ct = buf + pos;
        pos += 3 * static_cast<size_t>(ct_n);
    }
    if (!ct) return nullptr;
    const bool interlaced = (iflags & 0x40) != 0;
    if (pos >= len) return nullptr;
    const int min_code = buf[pos++];
    if (min_code < 1 || min_code > 11) return nullptr;

    // LZW over the concatenated sub-blocks
    const size_t npix = static_cast<size_t>(iw) * ih;
    std::vector<uint8_t> indices;
    indices.reserve(npix);
    // dictionary: prefix chain + last byte per code
    std::vector<int16_t> prefix(4096, -1);
    std::vector<uint8_t> last(4096), first(4096);
    const int clear = 1 << min_code;
    const int eoi = clear + 1;
    int next_code = eoi + 1, code_size = min_code + 1, prev = -1;
    for (int c = 0; c < clear; ++c) {
        last[c] = first[c] = static_cast<uint8_t>(c);
    }
    uint32_t bits = 0;
    int nbits = 0;
    size_t block_rem = 0;
    std::vector<uint8_t> stack;
    stack.reserve(4096);
    bool done = false;
    while (!done && indices.size() < npix) {
        while (nbits < code_size) {
            if (block_rem == 0) {
                if (pos >= len) return nullptr;
                block_rem = buf[pos++];
                if (block_rem == 0) { done = true; break; }
            }
            if (pos >= len) return nullptr;
            bits |= static_cast<uint32_t>(buf[pos++]) << nbits;
            nbits += 8;
            --block_rem;
        }
        if (done) break;
        const int code = static_cast<int>(bits & ((1u << code_size) - 1));
        bits >>= code_size;
        nbits -= code_size;
        if (code == clear) {
            next_code = eoi + 1;
            code_size = min_code + 1;
            prev = -1;
            continue;
        }
        if (code == eoi) break;
        if (code > next_code || (code == next_code && prev < 0)) return nullptr;
        // expand `code` (or prev+first(prev) for the not-yet-defined code)
        int cur = code;
        if (code == next_code) {
            stack.push_back(first[prev]);
            cur = prev;
        }
        while (cur >= clear + 2) {  // walk the prefix chain
            stack.push_back(last[cur]);
            cur = prefix[cur];
        }
        stack.push_back(last[cur]);
        for (size_t k = stack.size(); k-- > 0 && indices.size() < npix;)
            indices.push_back(stack[k]);
        stack.clear();
        if (prev >= 0 && next_code < 4096) {
            prefix[next_code] = static_cast<int16_t>(prev);
            last[next_code] = first[code == next_code ? prev : code];
            first[next_code] = first[prev];
            if (next_code + 1 == (1 << code_size) && code_size < 12)
                ++code_size;
            ++next_code;
        }
        prev = code;
    }
    if (indices.size() < npix) return nullptr;

    uint8_t *out = static_cast<uint8_t *>(
        std::malloc(static_cast<size_t>(sw) * sh * 3));
    if (!out) return nullptr;
    std::memset(out, 0, static_cast<size_t>(sw) * sh * 3);
    // row order: sequential or the 4 interlace passes
    int row_of[4] = {0, 4, 2, 1}, step_of[4] = {8, 8, 4, 2};
    size_t src_row = 0;
    auto emit_row = [&](int y) {
        const uint8_t *src = indices.data() + src_row * iw;
        uint8_t *dst = out + (static_cast<size_t>(iy + y) * sw + ix) * 3;
        for (int x = 0; x < iw; ++x) {
            const int ci = src[x] < ct_n ? src[x] : 0;
            dst[3 * x + 0] = ct[3 * ci + 0];
            dst[3 * x + 1] = ct[3 * ci + 1];
            dst[3 * x + 2] = ct[3 * ci + 2];
        }
        ++src_row;
    };
    if (interlaced) {
        for (int p = 0; p < 4; ++p)
            for (int y = row_of[p]; y < ih; y += step_of[p]) emit_row(y);
    } else {
        for (int y = 0; y < ih; ++y) emit_row(y);
    }
    *w = sw;
    *h = sh;
    return out;
}

// ----------------------------------------------------------------- PSD ----
// 8-bit RGB composite image data (raw or PackBits RLE) — the slice of PSD
// stb_image reads. Layers/resources are skipped; channels are planar.

uint8_t *decode_psd(const uint8_t *buf, size_t len, int *w, int *h) {
    auto rd32 = [&](size_t off) -> uint32_t {
        return (static_cast<uint32_t>(buf[off]) << 24) |
               (static_cast<uint32_t>(buf[off + 1]) << 16) |
               (static_cast<uint32_t>(buf[off + 2]) << 8) |
               static_cast<uint32_t>(buf[off + 3]);
    };
    auto rd16 = [&](size_t off) -> uint16_t {
        return static_cast<uint16_t>((buf[off] << 8) | buf[off + 1]);
    };
    if (len < 26 + 4 || std::memcmp(buf, "8BPS", 4) != 0 || rd16(4) != 1)
        return nullptr;
    const int channels = rd16(12);
    const uint32_t height = rd32(14);
    const uint32_t width = rd32(18);
    const int depth = rd16(22);
    const int mode = rd16(24);
    if (channels < 3 || channels > 16 || depth != 8 || mode != 3)
        return nullptr;  // 8-bit RGB only
    if (width == 0 || height == 0 ||
        static_cast<size_t>(width) * height > VN_MAX_PIXELS)
        return nullptr;
    size_t pos = 26;
    for (int sec = 0; sec < 3; ++sec) {  // color data, resources, layers
        if (pos + 4 > len) return nullptr;
        const uint32_t n = rd32(pos);
        pos += 4 + n;
        if (pos > len) return nullptr;
    }
    if (pos + 2 > len) return nullptr;
    const int compression = rd16(pos);
    pos += 2;
    const size_t npix = static_cast<size_t>(width) * height;
    std::vector<uint8_t> planes(npix * 3);
    if (compression == 0) {
        if (pos + npix * 3 > len) return nullptr;  // need the RGB planes
        for (int c = 0; c < 3; ++c)
            std::memcpy(planes.data() + npix * c, buf + pos + npix * c, npix);
    } else if (compression == 1) {  // PackBits, per-row byte counts first
        const size_t counts = static_cast<size_t>(height) * channels;
        if (pos + counts * 2 > len) return nullptr;
        size_t data = pos + counts * 2;
        // rows are stored channel-major; decode first 3 channels, skip rest
        size_t row_idx = 0;
        for (int c = 0; c < channels; ++c) {
            for (uint32_t y = 0; y < height; ++y, ++row_idx) {
                const uint16_t nbytes = rd16(pos + row_idx * 2);
                if (c >= 3) { data += nbytes; continue; }
                const uint8_t *src = buf + data;
                const uint8_t *end = src + nbytes;
                if (data + nbytes > len) return nullptr;
                uint8_t *dst = planes.data() + npix * c +
                               static_cast<size_t>(y) * width;
                size_t xpos = 0;
                while (src < end && xpos < width) {
                    const int8_t n = static_cast<int8_t>(*src++);
                    if (n >= 0) {
                        const size_t cnt = static_cast<size_t>(n) + 1;
                        if (src + cnt > end || xpos + cnt > width) return nullptr;
                        std::memcpy(dst + xpos, src, cnt);
                        src += cnt;
                        xpos += cnt;
                    } else if (n != -128) {
                        const size_t cnt = static_cast<size_t>(-n) + 1;
                        if (src >= end || xpos + cnt > width) return nullptr;
                        std::memset(dst + xpos, *src++, cnt);
                        xpos += cnt;
                    }
                }
                if (xpos != width) return nullptr;
                data += nbytes;
            }
        }
    } else {
        return nullptr;
    }
    uint8_t *out = static_cast<uint8_t *>(std::malloc(npix * 3));
    if (!out) return nullptr;
    for (size_t i = 0; i < npix; ++i) {
        out[3 * i + 0] = planes[i];
        out[3 * i + 1] = planes[npix + i];
        out[3 * i + 2] = planes[2 * npix + i];
    }
    *w = static_cast<int>(width);
    *h = static_cast<int>(height);
    return out;
}

// ----------------------------------------------------------------- HDR ----
// Radiance RGBE (.hdr/.pic): header lines, "-Y h +X w" resolution, new-RLE
// or flat scanlines; tone-mapped to LDR exactly like stb's default
// (linear scale 1, gamma 2.2) so the forced-RGB8 contract holds.

uint8_t *decode_hdr(const uint8_t *buf, size_t len, int *w, int *h) {
    if (len < 11 || buf[0] != '#' || buf[1] != '?') return nullptr;
    size_t pos = 0;
    auto read_line = [&](char *line, size_t cap) -> bool {
        size_t i = 0;
        while (pos < len && buf[pos] != '\n') {
            if (i + 1 < cap) line[i++] = static_cast<char>(buf[pos]);
            ++pos;
        }
        if (pos >= len) return false;
        ++pos;  // consume newline
        line[i] = 0;
        return true;
    };
    char line[256];
    if (!read_line(line, sizeof line)) return nullptr;  // #?RADIANCE / #?RGBE
    bool fmt_ok = false;
    for (;;) {  // header lines until the blank separator
        if (!read_line(line, sizeof line)) return nullptr;
        if (line[0] == 0) break;
        if (std::strncmp(line, "FORMAT=32-bit_rle_rgbe", 22) == 0) fmt_ok = true;
    }
    if (!fmt_ok) return nullptr;
    if (!read_line(line, sizeof line)) return nullptr;  // -Y h +X w
    int height = 0, width = 0;
    if (std::sscanf(line, "-Y %d +X %d", &height, &width) != 2) return nullptr;
    if (width <= 0 || height <= 0 ||
        static_cast<size_t>(width) * height > VN_MAX_PIXELS)
        return nullptr;
    const size_t npix = static_cast<size_t>(width) * height;
    uint8_t *out = static_cast<uint8_t *>(std::malloc(npix * 3));
    if (!out) return nullptr;
    std::vector<uint8_t> scan(static_cast<size_t>(width) * 4);
    auto tonemap = [&](size_t i, const uint8_t *rgbe) {
        uint8_t *dst = out + 3 * i;
        if (rgbe[3] == 0) {
            dst[0] = dst[1] = dst[2] = 0;
            return;
        }
        const float f = std::ldexp(1.0f, rgbe[3] - (128 + 8));
        for (int c = 0; c < 3; ++c) {
            float v = std::pow(rgbe[c] * f, 1.0f / 2.2f) * 255.0f;
            dst[c] = v <= 0 ? 0 : v >= 255 ? 255 : static_cast<uint8_t>(v + 0.5f);
        }
    };
    for (int y = 0; y < height; ++y) {
        if (pos + 4 > len) { std::free(out); return nullptr; }
        const uint8_t *hdr4 = buf + pos;
        const bool new_rle = hdr4[0] == 2 && hdr4[1] == 2 &&
                             ((hdr4[2] << 8) | hdr4[3]) == width &&
                             width >= 8 && width < 32768;
        if (new_rle) {
            pos += 4;
            for (int c = 0; c < 4; ++c) {  // per-component RLE
                int x = 0;
                while (x < width) {
                    if (pos >= len) { std::free(out); return nullptr; }
                    int cnt = buf[pos++];
                    if (cnt > 128) {  // run
                        cnt -= 128;
                        if (pos >= len || x + cnt > width) {
                            std::free(out); return nullptr;
                        }
                        for (int k = 0; k < cnt; ++k)
                            scan[static_cast<size_t>(x + k) * 4 + c] = buf[pos];
                        ++pos;
                    } else {  // literal
                        if (cnt == 0 || pos + cnt > len || x + cnt > width) {
                            std::free(out); return nullptr;
                        }
                        for (int k = 0; k < cnt; ++k)
                            scan[static_cast<size_t>(x + k) * 4 + c] = buf[pos + k];
                        pos += cnt;
                    }
                    x += cnt;
                }
            }
            for (int x = 0; x < width; ++x)
                tonemap(static_cast<size_t>(y) * width + x,
                        &scan[static_cast<size_t>(x) * 4]);
        } else {  // flat RGBE pixels
            if (pos + static_cast<size_t>(width) * 4 > len) {
                std::free(out); return nullptr;
            }
            for (int x = 0; x < width; ++x)
                tonemap(static_cast<size_t>(y) * width + x,
                        buf + pos + static_cast<size_t>(x) * 4);
            pos += static_cast<size_t>(width) * 4;
        }
    }
    *w = width;
    *h = height;
    return out;
}

uint8_t *read_file(const char *path, size_t *len) {
    FILE *f = std::fopen(path, "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    if (sz < 0) {
        std::fclose(f);
        return nullptr;
    }
    std::fseek(f, 0, SEEK_SET);
    uint8_t *buf = static_cast<uint8_t *>(std::malloc(sz ? sz : 1));
    if (!buf) {
        std::fclose(f);
        return nullptr;
    }
    size_t got = std::fread(buf, 1, sz, f);
    std::fclose(f);
    if (got != static_cast<size_t>(sz)) {
        std::free(buf);
        return nullptr;
    }
    *len = got;
    return buf;
}

}  // namespace

// ---------------------------------------------------------------- C API ----

uint8_t *vn_decode_mem(const uint8_t *buf, size_t len, int *w, int *h) {
    if (!buf || len < 4) return nullptr;
    // dispatch on magic: JPEG SOI / PNG signature / BMP / binary PNM /
    // GIF / PSD / Radiance HDR; TGA last (no magic — strict header probe)
    if (buf[0] == 0xFF && buf[1] == 0xD8) return decode_jpeg(buf, len, w, h);
    if (buf[0] == 0x89 && buf[1] == 'P') return decode_png(buf, len, w, h);
    if (buf[0] == 'B' && buf[1] == 'M') return decode_bmp(buf, len, w, h);
    if (buf[0] == 'P' && (buf[1] == '5' || buf[1] == '6'))
        return decode_pnm(buf, len, w, h);
    if (std::memcmp(buf, "GIF8", 4) == 0) return decode_gif(buf, len, w, h);
    if (std::memcmp(buf, "8BPS", 4) == 0) return decode_psd(buf, len, w, h);
    if (buf[0] == '#' && buf[1] == '?') return decode_hdr(buf, len, w, h);
    // fall through: try both (some JPEGs lack the classic prefix check),
    // then the magic-less TGA probe
    uint8_t *out = decode_jpeg(buf, len, w, h);
    if (out) return out;
    out = decode_png(buf, len, w, h);
    if (out) return out;
    return decode_tga(buf, len, w, h);
}

uint8_t *vn_decode_file(const char *path, int *w, int *h) {
    size_t len = 0;
    uint8_t *buf = read_file(path, &len);
    if (!buf) return nullptr;
    uint8_t *out = vn_decode_mem(buf, len, w, h);
    std::free(buf);
    return out;
}

// Decode n files with a worker pool; outs[i] == NULL marks failure.
// Returns the number of successful decodes.
int vn_decode_batch(const char **paths, int n, int n_threads,
                    uint8_t **outs, int *ws, int *hs) {
    if (n <= 0) return 0;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n) n_threads = n;
    std::atomic<int> next(0), ok(0);
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n) break;
            outs[i] = vn_decode_file(paths[i], &ws[i], &hs[i]);
            if (outs[i]) ok.fetch_add(1);
        }
    };
    if (n_threads == 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        pool.reserve(n_threads);
        for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
        for (auto &th : pool) th.join();
    }
    return ok.load();
}

}  // extern "C"
