/* jpegdec.c — scaled JPEG decode + fused crop/bilinear-resize.
 *
 * Host-side decode kernel for apex_tpu_torch.data.image_folder — the native
 * analog of the reference recipe's DALI/worker decode stage
 * (examples/imagenet/main_amp.py:207-232 leans on DataLoader workers and
 * the README recommends DALI beyond that).  Two wins over the PIL path:
 *
 *   1. DCT-domain scaled decode: libjpeg(-turbo) can emit the image at
 *      M/8 scale (M=1..8) directly from the coefficients, so a 300px
 *      source headed for a 224px crop is never materialized at full
 *      resolution — the IDCT/upsample/color cost drops with the scale.
 *      The smallest M whose scaled crop still covers the requested
 *      output is chosen, so quality never drops below the resize target.
 *   2. The crop + bilinear resize is fused into the same pass over the
 *      decoded rows (separable weights precomputed per output column),
 *      replacing PIL's full-image resize-then-crop.
 *
 * Decoding stops (jpeg_abort_decompress) as soon as the last row of the
 * crop has been read, so bottom-of-image rows outside a training crop are
 * never IDCT'd.  All errors longjmp back and return nonzero — the Python
 * caller falls back to PIL; this file never exit()s or prints.
 *
 * Compiled lazily with the system cc into build/apex_tpu_torch/ (see
 * apex_tpu_torch/data/_jpeg_native.py) and linked against the system
 * libjpeg; no build step at install time.
 */

#include <stddef.h>
#include <stdio.h> /* jpeglib.h needs size_t/FILE declared first */
#include <jpeglib.h>
#include <setjmp.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

struct err_mgr {
    struct jpeg_error_mgr pub;
    jmp_buf jmp;
};

static void err_exit(j_common_ptr cinfo) {
    struct err_mgr *e = (struct err_mgr *)cinfo->err;
    longjmp(e->jmp, 1);
}

static void err_silent(j_common_ptr cinfo, int msg_level) {
    /* swallow the text but keep the count: the default emit_message is
     * what increments num_warnings, which the truncation check reads */
    if (msg_level < 0)
        cinfo->err->num_warnings++;
}

/* Header-only parse: full-resolution (h, w).  rc 0 on success. */
int jpegdec_dims(const unsigned char *data, size_t len, int *h, int *w) {
    struct jpeg_decompress_struct cinfo;
    struct err_mgr jerr;

    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = err_exit;
    jerr.pub.emit_message = err_silent;
    if (setjmp(jerr.jmp)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, (unsigned char *)data, (unsigned long)len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    *h = (int)cinfo.image_height;
    *w = (int)cinfo.image_width;
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

/* Decode `data`, crop (cy, cx, ch, cw) given in FULL-RESOLUTION source
 * coordinates, bilinear-resize the crop to (out_h, out_w) RGB uint8 into
 * `out` (row-major HWC, caller-allocated out_h*out_w*3 bytes).  hflip
 * mirrors the output horizontally (folded into the column weights — free).
 *
 * rc: 0 ok; 1 decode error (corrupt/truncated); 2 unsupported colorspace
 * (e.g. CMYK — caller should fall back to PIL); 3 bad arguments.
 */
int jpegdec_decode_crop_resize(const unsigned char *data, size_t len,
                               int cy, int cx, int ch, int cw,
                               int out_h, int out_w, int hflip,
                               unsigned char *out) {
    struct jpeg_decompress_struct cinfo;
    struct err_mgr jerr;
    /* volatile: written between setjmp and longjmp, read in the error
     * path — without it the cleanup would free setjmp-time register
     * copies (C11 7.13.2.1p3) */
    unsigned char *volatile region = NULL; /* scaled rows covering crop */
    unsigned char *volatile scanline = NULL;
    int *volatile x0s = NULL;
    float *volatile fxs = NULL;

    if (ch <= 0 || cw <= 0 || out_h <= 0 || out_w <= 0)
        return 3;

    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = err_exit;
    jerr.pub.emit_message = err_silent;
    if (setjmp(jerr.jmp)) {
        jpeg_destroy_decompress(&cinfo);
        free(region);
        free(scanline);
        free(x0s);
        free(fxs);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, (unsigned char *)data, (unsigned long)len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }

    int src_h = (int)cinfo.image_height;
    int src_w = (int)cinfo.image_width;
    if (cy < 0 || cx < 0 || cy + ch > src_h || cx + cw > src_w) {
        jpeg_destroy_decompress(&cinfo);
        return 3;
    }

    /* Smallest M/8 scale whose scaled crop still covers the output (no
     * DCT upscaling past full resolution: if the crop is smaller than
     * the output, decode it 1:1 and bilinear-upscale). */
    int m = 8;
    for (int cand = 1; cand <= 8; cand++) {
        if ((long)ch * cand / 8 >= out_h && (long)cw * cand / 8 >= out_w) {
            m = cand;
            break;
        }
    }
    cinfo.scale_num = (unsigned int)m;
    cinfo.scale_denom = 8;
    cinfo.out_color_space = JCS_RGB; /* gray->RGB handled by libjpeg */
    if (!jpeg_start_decompress(&cinfo)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    if (cinfo.output_components != 3) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return 2; /* CMYK etc. — PIL fallback */
    }

    int sw = (int)cinfo.output_width;
    int sh = (int)cinfo.output_height;
    /* Crop box mapped into scaled coordinates (exact, as doubles). */
    double sfy = (double)sh / (double)src_h;
    double sfx = (double)sw / (double)src_w;
    double scy = cy * sfy, sch = ch * sfy;
    double scx = cx * sfx, scw = cw * sfx;

    /* Scaled rows needed for bilinear sampling over the crop. */
    double y_lo = scy + 0.5 * sch / out_h - 0.5;
    double y_hi = scy + (out_h - 0.5) * sch / out_h - 0.5;
    int r0 = (int)y_lo;
    if (r0 < 0)
        r0 = 0;
    int r1 = (int)y_hi + 1;
    if (r1 > sh - 1)
        r1 = sh - 1;
    if (r1 < r0)
        r1 = r0;
    int n_rows = r1 - r0 + 1;

    region = malloc((size_t)n_rows * sw * 3);
    scanline = malloc((size_t)sw * 3);
    x0s = malloc(sizeof(int) * (size_t)out_w);
    fxs = malloc(sizeof(float) * (size_t)out_w);
    if (!region || !scanline || !x0s || !fxs) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        free(region);
        free(scanline);
        free(x0s);
        free(fxs);
        return 1;
    }

    /* Read scaled rows; discard above the crop, stop after its last row.
     * (Rows above still pay IDCT — correct for every libjpeg build; the
     * scaled decode is where the bulk of the win is.) */
    while ((int)cinfo.output_scanline <= r1) {
        int row = (int)cinfo.output_scanline;
        JSAMPROW dst = (row >= r0)
                           ? (JSAMPROW)(region + (size_t)(row - r0) * sw * 3)
                           : (JSAMPROW)scanline;
        if (jpeg_read_scanlines(&cinfo, &dst, 1) != 1)
            break;
    }
    /* A truncated stream either stalls read_scanlines (loop breaks short
     * of r1) or fakes an EOI with a JWRN_JPEG_EOF warning (swallowed by
     * err_silent) and pads gray — both must report failure, not return
     * interpolated garbage with rc 0. */
    int incomplete = ((int)cinfo.output_scanline <= r1
                      || cinfo.err->num_warnings != 0);
    jpeg_abort_decompress(&cinfo); /* skip rows below the crop */
    jpeg_destroy_decompress(&cinfo);
    if (incomplete) {
        free(region);
        free(scanline);
        free(x0s);
        free(fxs);
        return 1;
    }

    /* Separable bilinear: precompute column index+weight (hflip folds in
     * here), then one pass over output rows. */
    for (int j = 0; j < out_w; j++) {
        int jj = hflip ? (out_w - 1 - j) : j;
        double sx = scx + (jj + 0.5) * scw / out_w - 0.5;
        if (sx < 0)
            sx = 0;
        if (sx > sw - 1)
            sx = sw - 1;
        int x0 = (int)sx;
        if (x0 > sw - 2)
            x0 = sw - 2 >= 0 ? sw - 2 : 0;
        x0s[j] = x0;
        fxs[j] = (float)(sx - x0);
        if (sw == 1)
            fxs[j] = 0.0f;
    }
    for (int i = 0; i < out_h; i++) {
        double sy = scy + (i + 0.5) * sch / out_h - 0.5;
        if (sy < 0)
            sy = 0;
        if (sy > sh - 1)
            sy = sh - 1;
        int y0 = (int)sy - r0;
        if (y0 > n_rows - 2)
            y0 = n_rows - 2 >= 0 ? n_rows - 2 : 0;
        if (y0 < 0)
            y0 = 0;
        float fy = (float)(sy - (y0 + r0));
        if (fy < 0.0f || n_rows == 1)
            fy = 0.0f;
        const unsigned char *ra = region + (size_t)y0 * sw * 3;
        const unsigned char *rb =
            region + (size_t)(n_rows == 1 ? y0 : y0 + 1) * sw * 3;
        unsigned char *orow = out + (size_t)i * out_w * 3;
        for (int j = 0; j < out_w; j++) {
            int x0 = x0s[j];
            int x1 = (sw == 1) ? x0 : x0 + 1;
            float fx = fxs[j];
            const unsigned char *a0 = ra + (size_t)x0 * 3;
            const unsigned char *a1 = ra + (size_t)x1 * 3;
            const unsigned char *b0 = rb + (size_t)x0 * 3;
            const unsigned char *b1 = rb + (size_t)x1 * 3;
            for (int c = 0; c < 3; c++) {
                float top = a0[c] + fx * (a1[c] - a0[c]);
                float bot = b0[c] + fx * (b1[c] - b0[c]);
                float v = top + fy * (bot - top);
                orow[j * 3 + c] = (unsigned char)(v + 0.5f);
            }
        }
    }

    free(region);
    free(scanline);
    free(x0s);
    free(fxs);
    return 0;
}
