// Native host image pipeline: threaded JPEG/PNG decode + PIL-exact bicubic
// resize.
//
// Replaces the hot part of the reference's torch DataLoader workers
// (src/dataset.py:60-73,101-106): every epoch decodes and
// bicubically resizes every image on the host. The Python path (PIL) runs
// one image at a time under the GIL; this pool decodes a whole batch across
// N threads and is materially faster per core (no Python object churn).
//
// The resize is a faithful reimplementation of Pillow's convolution
// resampling (Resample.c): bicubic kernel a=-0.5, filter support scaled by
// the downscale ratio (antialias), per-axis separable passes with 8-bit
// intermediates and the same fixed-point coefficient quantization
// (PRECISION_BITS, round-half-away, clip8) — so cached images are
// interchangeable with the PIL path.
//
// Build: g++ -O3 -shared -fPIC image_pool.cpp -ljpeg -lpng -lz -lpthread

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// Decode-bomb guard: refuse images whose HEADER declares more pixels than
// any real photo (100 MP). Untrusted dimensions otherwise size allocations.
constexpr size_t kMaxPixels = 100000000ULL;

// ------------------------------------------------------------------ resize
// Pillow Resample.c semantics, 8 bits per channel.

constexpr int PRECISION_BITS = 32 - 8 - 2;

inline unsigned char clip8(int in) {
    if (in >= (255 << PRECISION_BITS)) return 255;
    if (in <= 0) return 0;
    return (unsigned char)(in >> PRECISION_BITS);
}

double bicubic_filter(double x) {
    const double a = -0.5;
    if (x < 0.0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

// Pillow precompute_coeffs for the full [0, inSize] box.
int precompute_coeffs(int inSize, int outSize, std::vector<int>& bounds,
                      std::vector<double>& kk) {
    const double support_base = 2.0;  // bicubic
    double scale = (double)inSize / outSize;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = support_base * filterscale;
    int ksize = (int)ceil(support) * 2 + 1;

    bounds.resize(outSize * 2);
    kk.assign((size_t)outSize * ksize, 0.0);
    for (int xx = 0; xx < outSize; xx++) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > inSize) xmax = inSize;
        xmax -= xmin;
        double* k = &kk[(size_t)xx * ksize];
        int x = 0;
        for (; x < xmax; x++) {
            double w = bicubic_filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (x = 0; x < xmax; x++) {
            if (ww != 0.0) k[x] /= ww;
        }
        bounds[xx * 2 + 0] = xmin;
        bounds[xx * 2 + 1] = xmax;
    }
    return ksize;
}

void normalize_coeffs_8bpc(const std::vector<double>& prekk,
                           std::vector<int>& kk) {
    kk.resize(prekk.size());
    for (size_t x = 0; x < prekk.size(); x++) {
        if (prekk[x] < 0) {
            kk[x] = (int)(-0.5 + prekk[x] * (1 << PRECISION_BITS));
        } else {
            kk[x] = (int)(0.5 + prekk[x] * (1 << PRECISION_BITS));
        }
    }
}

// in: [inH, inW, 3] -> out: [inH, outW, 3]
// Three channel accumulators per output pixel so every tap is one
// contiguous 3-byte load (single pass over the taps, auto-vectorizable).
void resample_horizontal(const unsigned char* in, int inH, int inW,
                         unsigned char* out, int outW,
                         const std::vector<int>& bounds,
                         const std::vector<int>& kk, int ksize) {
    for (int yy = 0; yy < inH; yy++) {
        const unsigned char* row = in + (size_t)yy * inW * 3;
        unsigned char* orow = out + (size_t)yy * outW * 3;
        for (int xx = 0; xx < outW; xx++) {
            int xmin = bounds[xx * 2 + 0];
            int xmax = bounds[xx * 2 + 1];
            const int* k = &kk[(size_t)xx * ksize];
            int s0 = 1 << (PRECISION_BITS - 1), s1 = s0, s2 = s0;
            const unsigned char* p = row + (size_t)xmin * 3;
            for (int x = 0; x < xmax; x++, p += 3) {
                int c = k[x];
                s0 += p[0] * c;
                s1 += p[1] * c;
                s2 += p[2] * c;
            }
            orow[(size_t)xx * 3 + 0] = clip8(s0);
            orow[(size_t)xx * 3 + 1] = clip8(s1);
            orow[(size_t)xx * 3 + 2] = clip8(s2);
        }
    }
}

// in: [inH, W, 3] -> out: [outH, W, 3]
// Row-wise AXPY into an int32 row accumulator: each tap streams the whole
// contiguous [W*3] source row (gcc auto-vectorizes both loops).
void resample_vertical(const unsigned char* in, int inH, int W,
                       unsigned char* out, int outH,
                       const std::vector<int>& bounds,
                       const std::vector<int>& kk, int ksize) {
    const int rowlen = W * 3;
    std::vector<int> acc(rowlen);
    for (int yy = 0; yy < outH; yy++) {
        int ymin = bounds[yy * 2 + 0];
        int ymax = bounds[yy * 2 + 1];
        const int* k = &kk[(size_t)yy * ksize];
        int init = 1 << (PRECISION_BITS - 1);
        for (int i = 0; i < rowlen; i++) acc[i] = init;
        for (int y = 0; y < ymax; y++) {
            const unsigned char* srow = in + (size_t)(y + ymin) * rowlen;
            int c = k[y];
            for (int i = 0; i < rowlen; i++) acc[i] += srow[i] * c;
        }
        unsigned char* orow = out + (size_t)yy * rowlen;
        for (int i = 0; i < rowlen; i++) orow[i] = clip8(acc[i]);
    }
}

// PIL Image.resize((S, S), BICUBIC): horizontal pass, then vertical.
void resize_bicubic(const unsigned char* in, int inH, int inW,
                    unsigned char* out, int outS) {
    std::vector<int> boundsH, boundsV, kkHi, kkVi;
    std::vector<double> kkH, kkV;
    int ksizeH = precompute_coeffs(inW, outS, boundsH, kkH);
    int ksizeV = precompute_coeffs(inH, outS, boundsV, kkV);
    normalize_coeffs_8bpc(kkH, kkHi);
    normalize_coeffs_8bpc(kkV, kkVi);

    std::vector<unsigned char> tmp((size_t)inH * outS * 3);
    resample_horizontal(in, inH, inW, tmp.data(), outS, boundsH, kkHi, ksizeH);
    resample_vertical(tmp.data(), inH, outS, out, outS, boundsV, kkVi, ksizeV);
}

// ------------------------------------------------------------------ decode

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* e = (JpegErr*)cinfo->err;
    longjmp(e->jmp, 1);
}

// -> RGB buffer [h, w, 3]; returns true on success.
bool decode_jpeg(const unsigned char* buf, size_t len,
                 std::vector<unsigned char>& rgb, int* w, int* h) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jmp)) {
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, len);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    *w = cinfo.output_width;
    *h = cinfo.output_height;
    if (*w <= 0 || *h <= 0 || (size_t)*w * (size_t)*h > kMaxPixels) {
        // untrusted header dimensions: a crafted file can declare
        // 500000x500000 and drive a ~750 GB allocation — refuse instead
        // (the caller's PIL fallback enforces its own decompression-bomb
        // limits). 100 MP covers any real photo.
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    rgb.resize((size_t)*w * *h * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        unsigned char* row = &rgb[(size_t)cinfo.output_scanline * *w * 3];
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return true;
}

struct PngReadState {
    const unsigned char* data;
    size_t len, pos;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
    PngReadState* s = (PngReadState*)png_get_io_ptr(png);
    if (s->pos + n > s->len) {
        png_error(png, "read past end");
        return;
    }
    memcpy(out, s->data + s->pos, n);
    s->pos += n;
}

bool decode_png(const unsigned char* buf, size_t len,
                std::vector<unsigned char>& rgb, int* w, int* h) {
    png_structp png =
        png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    if (!png) return false;
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_read_struct(&png, nullptr, nullptr);
        return false;
    }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        return false;
    }
    PngReadState state{buf, len, 0};
    png_set_read_fn(png, &state, png_mem_read);
    png_read_info(png, info);

    if (png_get_bit_depth(png, info) > 8) {
        // 16-bit PNGs: PIL opens these as mode "I" and convert("RGB")
        // CLIPS at 255, which strip_16 (>>8) would not reproduce. Refuse
        // (ok=0) so the caller's PIL fallback keeps pixels identical.
        png_destroy_read_struct(&png, &info, nullptr);
        return false;
    }
    png_set_palette_to_rgb(png);
    png_set_expand_gray_1_2_4_to_8(png);
    png_set_strip_alpha(png);  // PIL convert("RGB") drops alpha
    png_set_gray_to_rgb(png);
    png_read_update_info(png, info);

    *w = png_get_image_width(png, info);
    *h = png_get_image_height(png, info);
    if (*w <= 0 || *h <= 0 || (size_t)*w * (size_t)*h > kMaxPixels) {
        png_destroy_read_struct(&png, &info, nullptr);
        return false;  // crafted-header bomb; see decode_jpeg
    }
    rgb.resize((size_t)*w * *h * 3);
    std::vector<png_bytep> rows(*h);
    for (int y = 0; y < *h; y++) rows[y] = &rgb[(size_t)y * *w * 3];
    png_read_image(png, rows.data());
    png_read_end(png, nullptr);
    png_destroy_read_struct(&png, &info, nullptr);
    return true;
}

bool decode_file(const char* path, std::vector<unsigned char>& rgb,
                 int* w, int* h) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    fseek(f, 0, SEEK_END);
    long len = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (len <= 8) {
        fclose(f);
        return false;
    }
    std::vector<unsigned char> buf((size_t)len);
    size_t got = fread(buf.data(), 1, (size_t)len, f);
    fclose(f);
    if (got != (size_t)len) return false;

    if (buf[0] == 0xFF && buf[1] == 0xD8) {
        return decode_jpeg(buf.data(), buf.size(), rgb, w, h);
    }
    if (buf[0] == 0x89 && buf[1] == 'P' && buf[2] == 'N' && buf[3] == 'G') {
        return decode_png(buf.data(), buf.size(), rgb, w, h);
    }
    return false;
}

bool decode_buffer(const unsigned char* buf, size_t len,
                   std::vector<unsigned char>& rgb, int* w, int* h) {
    if (len <= 8) return false;
    if (buf[0] == 0xFF && buf[1] == 0xD8) {
        return decode_jpeg(buf, len, rgb, w, h);
    }
    if (buf[0] == 0x89 && buf[1] == 'P' && buf[2] == 'N' && buf[3] == 'G') {
        return decode_png(buf, len, rgb, w, h);
    }
    return false;
}

}  // namespace

// ------------------------------------------------------------------ C API

extern "C" {

// Decode n images and resize to [out_size, out_size, 3] uint8, in parallel.
//   paths:     array of n C strings
//   out:       [n, out_size, out_size, 3] uint8, caller-allocated
//   wh:        [n, 2] int32 original (width, height)
//   ok:        [n] int32, 1 on success (failed slots untouched -> caller
//              falls back to the Python path for them)
//   n_threads: worker count (<=0 -> hardware_concurrency)
// Returns the number of successfully processed images.
int owlvit_decode_resize_batch(const char* const* paths, int n, int out_size,
                               unsigned char* out, int* wh, int* ok,
                               int n_threads) {
    if (n_threads <= 0) {
        n_threads = (int)std::thread::hardware_concurrency();
        if (n_threads <= 0) n_threads = 1;
    }
    if (n_threads > n) n_threads = n;
    std::atomic<int> next(0), good(0);
    const size_t stride = (size_t)out_size * out_size * 3;

    auto worker = [&]() {
        std::vector<unsigned char> rgb;
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n) return;
            int w = 0, h = 0;
            ok[i] = 0;
            // a C++ exception escaping a std::thread is std::terminate —
            // one corrupt file must fail its slot, not the whole process
            try {
                if (!decode_file(paths[i], rgb, &w, &h)) continue;
                resize_bicubic(rgb.data(), h, w, out + (size_t)i * stride,
                               out_size);
            } catch (...) {
                continue;
            }
            wh[i * 2 + 0] = w;
            wh[i * 2 + 1] = h;
            ok[i] = 1;
            good.fetch_add(1);
        }
    };

    if (n_threads == 1) {
        worker();
    } else {
        std::vector<std::thread> threads;
        threads.reserve(n_threads);
        for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
        for (auto& t : threads) t.join();
    }
    return good.load();
}

// Decode ONE in-memory JPEG/PNG (serving uploads — no file round trip).
//   out: malloc'd [h, w, 3] uint8 on success; caller frees with
//        owlvit_free_buffer. Returns 1 on success, 0 on failure (caller
//        falls back to PIL — e.g. 16-bit PNGs, other formats).
int owlvit_decode_bytes(const unsigned char* buf, size_t len,
                        unsigned char** out, int* w, int* h) {
    // no C++ exception may cross the C ABI into ctypes (std::terminate ->
    // SIGABRT of the serving process; a crafted upload reproduced it)
    try {
        std::vector<unsigned char> rgb;
        if (!decode_buffer(buf, len, rgb, w, h)) return 0;
        *out = (unsigned char*)malloc(rgb.size());
        if (!*out) return 0;
        memcpy(*out, rgb.data(), rgb.size());
        return 1;
    } catch (...) {
        return 0;
    }
}

void owlvit_free_buffer(unsigned char* p) { free(p); }

}  // extern "C"
