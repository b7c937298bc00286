// Host-side augmentation engine and PNG row unfilter of the PyTorch port
// (its own copy of smow_net_tpu/runtime/augment.cpp, the same arithmetic,
// plus `png_unfilter`).
//
// One fused pass over float32 HWC buffers per sample: shared flip + rotate
// (bilinear/reflect-101 for the images, nearest for the mask), per-image
// brightness/contrast and Gaussian blur (cv2's fixed small-kernel tables),
// and ImageNet normalization. `augment_batch` runs samples in parallel with
// OpenMP. `png_unfilter` reverses PNG's five row filters: Paeth and Sub
// depend on the byte to their left, so a row cannot be vectorised in numpy.
// Bound with ctypes by smow_net_tpu_torch/runtime/native.py, which builds
// this file at first use:
//   g++ -O3 -march=native -fopenmp -shared -fPIC augment.cpp -o libaugment.so

#include <cmath>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

// reflect-101 border: ... 2 1 | 0 1 2 ... n-1 | n-2 n-3 ...
inline int reflect101(int i, int n) {
    if (n == 1) return 0;
    while (i < 0 || i >= n) {
        if (i < 0) i = -i;
        if (i >= n) i = 2 * (n - 1) - i;
    }
    return i;
}

// rotate around the cv2-style center ((w/2-0.5, h/2-0.5)) by `angle` deg.
// dst(x,y) = src(M^-1 [x,y]); bilinear or nearest; reflect-101 border.
void rotate_hwc(const float* src, float* dst, int h, int w, int c,
                float angle_deg, bool nearest) {
    const double a = angle_deg * M_PI / 180.0;
    const double ca = std::cos(a), sa = std::sin(a);
    const double cx = w / 2.0 - 0.5, cy = h / 2.0 - 0.5;
    // cv2.getRotationMatrix2D(center, angle, 1): maps src->dst as
    //   [ ca  sa  (1-ca)cx - sa*cy ]
    //   [-sa  ca  sa*cx + (1-ca)cy ]
    // warpAffine(INTER_*) inverts it internally; invert analytically here.
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            // inverse rotation (rotate dst coords by -angle about center)
            const double dx = x - cx, dy = y - cy;
            const double sx = ca * dx - sa * dy + cx;
            const double sy = sa * dx + ca * dy + cy;
            float* out = dst + (static_cast<size_t>(y) * w + x) * c;
            if (nearest) {
                // cv2 INTER_NEAREST rounds via floor(x+0.5) semantics
                int ix = reflect101(static_cast<int>(std::floor(sx + 0.5)), w);
                int iy = reflect101(static_cast<int>(std::floor(sy + 0.5)), h);
                const float* in = src + (static_cast<size_t>(iy) * w + ix) * c;
                for (int k = 0; k < c; ++k) out[k] = in[k];
            } else {
                const int x0 = static_cast<int>(std::floor(sx));
                const int y0 = static_cast<int>(std::floor(sy));
                const float tx = static_cast<float>(sx - x0);
                const float ty = static_cast<float>(sy - y0);
                const int x0r = reflect101(x0, w), x1r = reflect101(x0 + 1, w);
                const int y0r = reflect101(y0, h), y1r = reflect101(y0 + 1, h);
                const float* p00 = src + (static_cast<size_t>(y0r) * w + x0r) * c;
                const float* p01 = src + (static_cast<size_t>(y0r) * w + x1r) * c;
                const float* p10 = src + (static_cast<size_t>(y1r) * w + x0r) * c;
                const float* p11 = src + (static_cast<size_t>(y1r) * w + x1r) * c;
                for (int k = 0; k < c; ++k) {
                    const float top = p00[k] + tx * (p01[k] - p00[k]);
                    const float bot = p10[k] + tx * (p11[k] - p10[k]);
                    out[k] = top + ty * (bot - top);
                }
            }
        }
    }
}

void flip_hwc(float* img, int h, int w, int c, int d) {
    // d: 0 vertical, 1 horizontal, -1 both (cv2 flip codes)
    std::vector<float> tmp(static_cast<size_t>(h) * w * c);
    std::memcpy(tmp.data(), img, tmp.size() * sizeof(float));
    for (int y = 0; y < h; ++y) {
        const int sy = (d == 0 || d == -1) ? h - 1 - y : y;
        for (int x = 0; x < w; ++x) {
            const int sx = (d == 1 || d == -1) ? w - 1 - x : x;
            std::memcpy(img + (static_cast<size_t>(y) * w + x) * c,
                        tmp.data() + (static_cast<size_t>(sy) * w + sx) * c,
                        c * sizeof(float));
        }
    }
}

// separable Gaussian blur; with sigma=0 cv2 getGaussianKernel uses FIXED
// small-kernel tables for ksize in {1,3,5,7}; border reflect-101.
void gaussian_blur(float* img, int h, int w, int c, int ksize) {
    std::vector<double> kern(ksize);
    const int r = ksize / 2;
    if (ksize == 3) {
        kern = {0.25, 0.5, 0.25};
    } else if (ksize == 5) {
        kern = {0.0625, 0.25, 0.375, 0.25, 0.0625};
    } else if (ksize == 7) {
        kern = {0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125};
    } else {
        const double sigma = 0.3 * ((ksize - 1) * 0.5 - 1.0) + 0.8;
        double s = 0;
        for (int i = 0; i < ksize; ++i) {
            const double d = i - r;
            kern[i] = std::exp(-d * d / (2 * sigma * sigma));
            s += kern[i];
        }
        for (auto& v : kern) v /= s;
    }

    std::vector<float> tmp(static_cast<size_t>(h) * w * c);
    // horizontal
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
            for (int k = 0; k < c; ++k) {
                double acc = 0;
                for (int t = 0; t < ksize; ++t) {
                    const int xx = reflect101(x + t - r, w);
                    acc += kern[t] * img[(static_cast<size_t>(y) * w + xx) * c + k];
                }
                tmp[(static_cast<size_t>(y) * w + x) * c + k] = static_cast<float>(acc);
            }
    // vertical
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
            for (int k = 0; k < c; ++k) {
                double acc = 0;
                for (int t = 0; t < ksize; ++t) {
                    const int yy = reflect101(y + t - r, h);
                    acc += kern[t] * tmp[(static_cast<size_t>(yy) * w + x) * c + k];
                }
                img[(static_cast<size_t>(y) * w + x) * c + k] = static_cast<float>(acc);
            }
}

const float kMean[3] = {0.485f, 0.456f, 0.406f};
const float kStd[3] = {0.229f, 0.224f, 0.225f};

void normalize_hwc(float* img, int h, int w) {
    const size_t n = static_cast<size_t>(h) * w;
    for (size_t i = 0; i < n; ++i)
        for (int k = 0; k < 3; ++k)
            img[i * 3 + k] = (img[i * 3 + k] - kMean[k]) / kStd[k];
}

}  // namespace

extern "C" {

// Full per-sample pipeline, mirroring CDDataset.get (data/dataset.py):
//   a, b: (h, w, 3) float32 in [0,1]; mask: (h, w) float32 {0,1}. In-place.
// flip_d: -2 = no flip, else cv2 flip code. angle: 0 = no rotate.
// For each image: alpha/beta contrast-brightness (applied if apply_cb),
// blur ksize in {0 (off), 3, 5}. Normalization applied last when requested.
void augment_sample(float* a, float* b, float* mask, int h, int w,
                    int flip_d, float angle,
                    int a_cb, float a_alpha, float a_beta, int a_blur,
                    int b_cb, float b_alpha, float b_beta, int b_blur,
                    int normalize) {
    if (flip_d != -2) {
        flip_hwc(a, h, w, 3, flip_d);
        flip_hwc(b, h, w, 3, flip_d);
        flip_hwc(mask, h, w, 1, flip_d);
    }
    if (angle != 0.0f) {
        std::vector<float> buf(static_cast<size_t>(h) * w * 3);
        std::memcpy(buf.data(), a, buf.size() * sizeof(float));
        rotate_hwc(buf.data(), a, h, w, 3, angle, false);
        std::memcpy(buf.data(), b, buf.size() * sizeof(float));
        rotate_hwc(buf.data(), b, h, w, 3, angle, false);
        std::vector<float> mbuf(static_cast<size_t>(h) * w);
        std::memcpy(mbuf.data(), mask, mbuf.size() * sizeof(float));
        rotate_hwc(mbuf.data(), mask, h, w, 1, angle, true);
    }
    float* imgs[2] = {a, b};
    const int cbs[2] = {a_cb, b_cb};
    const float alphas[2] = {a_alpha, b_alpha};
    const float betas[2] = {a_beta, b_beta};
    const int blurs[2] = {a_blur, b_blur};
    for (int i = 0; i < 2; ++i) {
        float* img = imgs[i];
        if (cbs[i]) {
            const size_t n = static_cast<size_t>(h) * w * 3;
            for (size_t j = 0; j < n; ++j) img[j] = img[j] * alphas[i] + betas[i];
        }
        if (blurs[i] > 0) gaussian_blur(img, h, w, 3, blurs[i]);
        if (normalize) normalize_hwc(img, h, w);
    }
}

// Batched variant: processes `n` samples in parallel with OpenMP.
void augment_batch(float* a, float* b, float* mask, int n, int h, int w,
                   const int* flip_d, const float* angle,
                   const int* a_cb, const float* a_alpha, const float* a_beta,
                   const int* a_blur,
                   const int* b_cb, const float* b_alpha, const float* b_beta,
                   const int* b_blur, int normalize) {
    const size_t img_sz = static_cast<size_t>(h) * w * 3;
    const size_t m_sz = static_cast<size_t>(h) * w;
#pragma omp parallel for schedule(dynamic)
    for (int i = 0; i < n; ++i) {
        augment_sample(a + i * img_sz, b + i * img_sz, mask + i * m_sz, h, w,
                       flip_d[i], angle[i],
                       a_cb[i], a_alpha[i], a_beta[i], a_blur[i],
                       b_cb[i], b_alpha[i], b_beta[i], b_blur[i], normalize);
    }
}

// Reverse PNG's row filters (PNG spec, section 9). `src` holds `height`
// rows of one filter-type byte and `row_bytes` filtered bytes (the inflated
// IDAT stream of a non-interlaced image); `dst` receives height * row_bytes
// bytes. `bpp` is the bytes per complete pixel (1..8), the distance of the
// "left" byte. Returns 0, or the 1-based row whose filter type is not 0..4.
int png_unfilter(const uint8_t* src, uint8_t* dst, int height, int row_bytes, int bpp) {
    const uint8_t* prior = nullptr;
    for (int y = 0; y < height; ++y) {
        const uint8_t* in = src + static_cast<size_t>(y) * (row_bytes + 1);
        uint8_t* out = dst + static_cast<size_t>(y) * row_bytes;
        const int filter = in[0];
        ++in;
        switch (filter) {
        case 0:
            std::memcpy(out, in, row_bytes);
            break;
        case 1:  // Sub
            for (int i = 0; i < row_bytes; ++i)
                out[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? out[i - bpp] : 0));
            break;
        case 2:  // Up
            for (int i = 0; i < row_bytes; ++i)
                out[i] = static_cast<uint8_t>(in[i] + (prior ? prior[i] : 0));
            break;
        case 3:  // Average
            for (int i = 0; i < row_bytes; ++i) {
                const int a = i >= bpp ? out[i - bpp] : 0;
                const int b = prior ? prior[i] : 0;
                out[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
            }
            break;
        case 4:  // Paeth
            for (int i = 0; i < row_bytes; ++i) {
                const int a = i >= bpp ? out[i - bpp] : 0;
                const int b = prior ? prior[i] : 0;
                const int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
                const int p = a + b - c;
                const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                out[i] = static_cast<uint8_t>(in[i] + pred);
            }
            break;
        default:
            return y + 1;
        }
        prior = out;
    }
    return 0;
}

}  // extern "C"
