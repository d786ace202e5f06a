/* Host-side image resampling and PNG decoding for the data loader.
 *
 * Copy of vivid_tpu/native/fast_image.c, so that both packages resize and
 * decode a frame to the same bits. Separable triangle-filter (antialiased
 * bilinear) resize of uint8 HWC RGB images to float32, the filter family of
 * PIL's Resampling.BILINEAR; a box-filter integer downscale; a minimal PNG
 * decoder. The loader is host-bound on small-core machines.
 *
 * Build: cc -O3 -fPIC -shared fast_image.c -o libfast_image.so -lz
 */

#include <limits.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* Triangle (linear) filter, support 1.0, scaled for downsampling like PIL. */
static double triangle(double x) {
    if (x < 0.0) x = -x;
    return (x < 1.0) ? (1.0 - x) : 0.0;
}

typedef struct {
    int lo;      /* first source index */
    int n;       /* number of taps */
    double *w;   /* normalized weights */
} Taps;

static Taps *build_taps(int src_size, int dst_size) {
    double scale = (double)src_size / (double)dst_size;
    double fscale = scale < 1.0 ? 1.0 : scale;   /* widen support on downscale */
    double support = 1.0 * fscale;
    Taps *taps = (Taps *)malloc(sizeof(Taps) * dst_size);
    for (int d = 0; d < dst_size; d++) {
        double center = (d + 0.5) * scale;
        int lo = (int)(center - support + 0.5);
        int hi = (int)(center + support + 0.5);
        if (lo < 0) lo = 0;
        if (hi > src_size) hi = src_size;
        int n = hi - lo;
        if (n < 1) { lo = lo > 0 ? lo - 1 : 0; n = 1; }
        double *w = (double *)malloc(sizeof(double) * n);
        double total = 0.0;
        for (int i = 0; i < n; i++) {
            w[i] = triangle(((lo + i) + 0.5 - center) / fscale);
            total += w[i];
        }
        if (total <= 0.0) { w[n / 2] = 1.0; total = 1.0; }
        for (int i = 0; i < n; i++) w[i] /= total;
        taps[d].lo = lo;
        taps[d].n = n;
        taps[d].w = w;
    }
    return taps;
}

static void free_taps(Taps *taps, int n) {
    for (int i = 0; i < n; i++) free(taps[i].w);
    free(taps);
}

/* src: uint8 [h, w, 3]; dst: float32 [size, size, 3] in [0, 255]. */
void resize_bilinear_u8(const uint8_t *src, int h, int w,
                        float *dst, int size) {
    Taps *xt = build_taps(w, size);
    Taps *yt = build_taps(h, size);

    /* Horizontal pass into a [h, size, 3] float buffer. */
    float *tmp = (float *)malloc(sizeof(float) * (size_t)h * size * 3);
    for (int y = 0; y < h; y++) {
        const uint8_t *row = src + (size_t)y * w * 3;
        float *trow = tmp + (size_t)y * size * 3;
        for (int x = 0; x < size; x++) {
            const Taps *t = &xt[x];
            double r = 0, g = 0, b = 0;
            for (int i = 0; i < t->n; i++) {
                const uint8_t *p = row + (size_t)(t->lo + i) * 3;
                r += t->w[i] * p[0];
                g += t->w[i] * p[1];
                b += t->w[i] * p[2];
            }
            trow[x * 3 + 0] = (float)r;
            trow[x * 3 + 1] = (float)g;
            trow[x * 3 + 2] = (float)b;
        }
    }

    /* Vertical pass. */
    for (int y = 0; y < size; y++) {
        const Taps *t = &yt[y];
        float *drow = dst + (size_t)y * size * 3;
        memset(drow, 0, sizeof(float) * size * 3);
        for (int i = 0; i < t->n; i++) {
            const float *trow = tmp + (size_t)(t->lo + i) * size * 3;
            double wgt = t->w[i];
            for (int x = 0; x < size * 3; x++) {
                drow[x] += (float)(wgt * trow[x]);
            }
        }
    }

    free(tmp);
    free_taps(xt, size);
    free_taps(yt, size);
}

/* ------------------------------------------------------------------------
 * Minimal PNG decoder for the host data loader (RealEstate10K frame trees
 * are PNG; PIL decode dominates loader time on 1-core hosts). 8-bit,
 * non-interlaced images, color types 0 (gray), 2 (RGB), 3 (palette),
 * 4 (gray+alpha), 6 (RGBA); output is always tightly-packed RGB. IDAT
 * streams inflate through zlib; rows unfilter per the PNG spec (filters
 * 0-4). Anything else returns a negative code and callers fall back to PIL.
 *
 * Build: cc -O3 -fPIC -shared fast_image.c -o libfast_image.so -lz
 */

#include <zlib.h>

static uint32_t be32(const uint8_t *p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16)
         | ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

#define PNG_ERR_SIG      -1   /* not a PNG */
#define PNG_ERR_FORMAT   -2   /* malformed chunk structure */
#define PNG_ERR_UNSUPP   -3   /* valid PNG, unsupported variant */
#define PNG_ERR_ZLIB     -4   /* inflate failure */
#define PNG_ERR_ALLOC    -5

static int png_header(const uint8_t *buf, long len, uint32_t *w, uint32_t *h,
                      int *depth, int *ctype, int *interlace) {
    static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    if (len < 33 || memcmp(buf, sig, 8) != 0) return PNG_ERR_SIG;
    if (be32(buf + 8) != 13 || memcmp(buf + 12, "IHDR", 4) != 0)
        return PNG_ERR_FORMAT;
    *w = be32(buf + 16);
    *h = be32(buf + 20);
    *depth = buf[24];
    *ctype = buf[25];
    *interlace = buf[28];
    if (*w == 0 || *h == 0 || *w > (1u << 24) || *h > (1u << 24))
        return PNG_ERR_FORMAT;
    return 0;
}

/* Dims probe so the caller can allocate the output. Returns 0 iff the image
 * is decodable by decode_png_rgb. */
int png_dims(const uint8_t *buf, long len, int *w, int *h) {
    uint32_t ww, hh;
    int depth, ctype, interlace;
    int rc = png_header(buf, len, &ww, &hh, &depth, &ctype, &interlace);
    if (rc != 0) return rc;
    if (depth != 8 || interlace != 0) return PNG_ERR_UNSUPP;
    if (ctype != 0 && ctype != 2 && ctype != 3 && ctype != 4 && ctype != 6)
        return PNG_ERR_UNSUPP;
    *w = (int)ww;
    *h = (int)hh;
    return 0;
}

static int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return a;
    return (pb <= pc) ? b : c;
}

/* buf/len: whole PNG file; out: caller-allocated [h*w*3] RGB. */
int decode_png_rgb(const uint8_t *buf, long len, uint8_t *out) {
    uint32_t w, h;
    int depth, ctype, interlace;
    int rc = png_header(buf, len, &w, &h, &depth, &ctype, &interlace);
    if (rc != 0) return rc;
    if (depth != 8 || interlace != 0) return PNG_ERR_UNSUPP;
    int ch;  /* bytes per pixel in the filtered stream */
    switch (ctype) {
        case 0: ch = 1; break;
        case 2: ch = 3; break;
        case 3: ch = 1; break;
        case 4: ch = 2; break;
        case 6: ch = 4; break;
        default: return PNG_ERR_UNSUPP;
    }

    uint8_t palette[256 * 3] = {0};  /* out-of-range indices read black, not
                                        uninitialized stack (short PLTE) */
    int have_palette = 0;

    size_t stride = (size_t)w * ch;
    size_t raw_size = (size_t)h * (stride + 1);
    /* zlib's avail_out is 32-bit; a >=4 GiB decompressed image would wrap
       the budget and could "succeed" with uninitialized tail bytes. Such
       images route to the PIL fallback instead. */
    if (raw_size > (size_t)UINT_MAX) return PNG_ERR_UNSUPP;
    uint8_t *raw = (uint8_t *)malloc(raw_size);
    if (raw == NULL) return PNG_ERR_ALLOC;

    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) { free(raw); return PNG_ERR_ZLIB; }
    zs.next_out = raw;
    zs.avail_out = (uInt)raw_size;

    long pos = 33;  /* first chunk after IHDR */
    int done = 0, zerr = 0;
    while (pos + 12 <= len && !done) {
        uint32_t clen = be32(buf + pos);
        const uint8_t *ctag = buf + pos + 4;
        const uint8_t *cdat = buf + pos + 8;
        if ((long)(pos + 12 + (long)clen) > len) { zerr = 1; break; }
        if (memcmp(ctag, "PLTE", 4) == 0) {
            if (clen > sizeof(palette) || clen % 3 != 0) { zerr = 1; break; }
            memcpy(palette, cdat, clen);
            have_palette = 1;
        } else if (memcmp(ctag, "IDAT", 4) == 0) {
            zs.next_in = (uint8_t *)cdat;
            zs.avail_in = clen;
            int ir = inflate(&zs, Z_NO_FLUSH);
            if (ir == Z_STREAM_END) done = 1;
            else if (ir != Z_OK && ir != Z_BUF_ERROR) { zerr = 1; break; }
        } else if (memcmp(ctag, "IEND", 4) == 0) {
            break;
        }
        pos += 12 + (long)clen;
    }
    size_t produced = raw_size - zs.avail_out;
    inflateEnd(&zs);
    if (zerr || produced != raw_size) { free(raw); return PNG_ERR_ZLIB; }
    if (ctype == 3 && !have_palette) { free(raw); return PNG_ERR_FORMAT; }

    /* Unfilter in place (raw rows keep their leading filter byte). */
    uint8_t *prev = NULL;
    for (uint32_t y = 0; y < h; y++) {
        uint8_t *row = raw + (size_t)y * (stride + 1);
        int filter = row[0];
        uint8_t *cur = row + 1;
        switch (filter) {
            case 0: break;
            case 1:
                for (size_t i = ch; i < stride; i++) cur[i] += cur[i - ch];
                break;
            case 2:
                if (prev) for (size_t i = 0; i < stride; i++) cur[i] += prev[i];
                break;
            case 3:
                for (size_t i = 0; i < stride; i++) {
                    int a = i >= (size_t)ch ? cur[i - ch] : 0;
                    int b = prev ? prev[i] : 0;
                    cur[i] += (uint8_t)((a + b) >> 1);
                }
                break;
            case 4:
                for (size_t i = 0; i < stride; i++) {
                    int a = i >= (size_t)ch ? cur[i - ch] : 0;
                    int b = prev ? prev[i] : 0;
                    int c = (prev && i >= (size_t)ch) ? prev[i - ch] : 0;
                    cur[i] += (uint8_t)paeth(a, b, c);
                }
                break;
            default:
                free(raw);
                return PNG_ERR_FORMAT;
        }
        prev = cur;
    }

    /* Expand to RGB. */
    for (uint32_t y = 0; y < h; y++) {
        const uint8_t *cur = raw + (size_t)y * (stride + 1) + 1;
        uint8_t *dst = out + (size_t)y * w * 3;
        switch (ctype) {
            case 0:
                for (uint32_t x = 0; x < w; x++) {
                    uint8_t g = cur[x];
                    dst[x * 3] = g; dst[x * 3 + 1] = g; dst[x * 3 + 2] = g;
                }
                break;
            case 2:
                memcpy(dst, cur, (size_t)w * 3);
                break;
            case 3:
                for (uint32_t x = 0; x < w; x++) {
                    const uint8_t *p = palette + cur[x] * 3;
                    dst[x * 3] = p[0]; dst[x * 3 + 1] = p[1]; dst[x * 3 + 2] = p[2];
                }
                break;
            case 4:
                for (uint32_t x = 0; x < w; x++) {
                    uint8_t g = cur[x * 2];
                    dst[x * 3] = g; dst[x * 3 + 1] = g; dst[x * 3 + 2] = g;
                }
                break;
            case 6:
                for (uint32_t x = 0; x < w; x++) {
                    dst[x * 3] = cur[x * 4];
                    dst[x * 3 + 1] = cur[x * 4 + 1];
                    dst[x * 3 + 2] = cur[x * 4 + 2];
                }
                break;
        }
    }
    free(raw);
    return 0;
}

/* Box-filter integer downscale: uint8 [h,w,3] -> float32 [h/f,w/f,3], the
 * exact area mean over each f x f block. Accumulates in uint32 (f <= 4096
 * cannot overflow: f*f*255 < 2^32) and divides once in float, which matches
 * numpy's reshape(...).mean(dtype=float32) bit-for-bit for the block sizes
 * the loader uses (integer sums are exact in fp32 below 2^24). This is the
 * collate's hot path for stored-resolution -> train-resolution downscales
 * (data/collate.py resize_image). */
void resize_box_u8(const uint8_t *src, int h, int w, int f, float *out) {
    int oh = h / f, ow = w / f;
    float n = (float)(f * f);  /* divide (not mul-by-reciprocal): matches
                                  numpy's true_divide rounding exactly */
    for (int oy = 0; oy < oh; oy++) {
        for (int ox = 0; ox < ow; ox++) {
            uint32_t s0 = 0, s1 = 0, s2 = 0;
            for (int dy = 0; dy < f; dy++) {
                const uint8_t *row = src + (((size_t)(oy * f + dy)) * w
                                            + (size_t)ox * f) * 3;
                for (int dx = 0; dx < f; dx++) {
                    s0 += row[dx * 3];
                    s1 += row[dx * 3 + 1];
                    s2 += row[dx * 3 + 2];
                }
            }
            float *o = out + ((size_t)oy * ow + ox) * 3;
            o[0] = (float)s0 / n;
            o[1] = (float)s1 / n;
            o[2] = (float)s2 / n;
        }
    }
}
