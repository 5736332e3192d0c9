/* Host-side peak-crop kernel of serve's staging.
 *
 * The port's copy of globalegomocap_tpu/native/hostcrop.c, unchanged in
 * its arithmetic.  C mirror of energy/terms.py:
 * crop_heatmaps_channels_last_np: the peak-centred k x k crop of each
 * joint's score map, the solver's sampling working set.
 * SequenceOptimizer.stage runs it once per chunk on the host; numpy needs
 * about five passes over the map stack (argmax, row gather, crop gather,
 * two clip+sum reductions), this kernel ONE streaming pass for peak and
 * total (J-contiguous inner loop) plus a k*k*J gather.
 *
 * Layouts (all float32, C-contiguous):
 *   heat    (F, H, W, J)        input maps
 *   crops   (F, k*k*J)          flat staged-crop contract (see
 *                               optimize/driver.py StagedBatch)
 *   origins (F, J, 2)           (oy, ox) per joint
 *   box     (F, J)              clip(crop,0) mass   (crop-guard)
 *   total   (F, J)              clip(map,0)  mass   (crop-guard)
 *
 * Argmax tie-breaking: first maximum in row-major (H*W) scan order —
 * identical to np.argmax/jnp.argmax on the flattened map.
 */

#include <stdint.h>

#define MAX_J 64  /* stack buffers; J is 15 in every deployed model */

void crop_peak_f32(const float *heat, int64_t F, int64_t H, int64_t W,
                   int64_t J, int64_t k, float *crops, float *origins,
                   float *box, float *total)
{
    if (J > MAX_J) return;  /* the binding refuses such inputs */
    for (int64_t f = 0; f < F; ++f) {
        const float *m = heat + f * H * W * J;
        float best[MAX_J];
        int64_t by[MAX_J], bx[MAX_J];
        float tot[MAX_J];
        for (int64_t j = 0; j < J; ++j) {
            best[j] = m[j];          /* value at (0, 0) */
            by[j] = 0; bx[j] = 0;
            tot[j] = 0.0f;
        }
        /* one streaming pass: per-joint peak + clipped total mass */
        for (int64_t y = 0; y < H; ++y) {
            const float *row = m + y * W * J;
            for (int64_t x = 0; x < W; ++x) {
                const float *px = row + x * J;
                for (int64_t j = 0; j < J; ++j) {
                    float v = px[j];
                    if (v > best[j]) { best[j] = v; by[j] = y; bx[j] = x; }
                    if (v > 0.0f) tot[j] += v;
                }
            }
        }
        /* origins (clamped so the k x k window stays inside the map) */
        float *org = origins + f * J * 2;
        int64_t oy[MAX_J], ox[MAX_J];
        for (int64_t j = 0; j < J; ++j) {
            int64_t y0 = by[j] - k / 2, x0 = bx[j] - k / 2;
            if (y0 < 0) y0 = 0; if (y0 > H - k) y0 = H - k;
            if (x0 < 0) x0 = 0; if (x0 > W - k) x0 = W - k;
            oy[j] = y0; ox[j] = x0;
            org[j * 2] = (float)y0;
            org[j * 2 + 1] = (float)x0;
        }
        /* gather crops in the flat (k, k, J) order + box mass */
        float *cr = crops + f * k * k * J;
        float bx_mass[MAX_J];
        for (int64_t j = 0; j < J; ++j) bx_mass[j] = 0.0f;
        for (int64_t i = 0; i < k; ++i) {
            for (int64_t x = 0; x < k; ++x) {
                float *dst = cr + (i * k + x) * J;
                for (int64_t j = 0; j < J; ++j) {
                    float v = m[((oy[j] + i) * W + (ox[j] + x)) * J + j];
                    dst[j] = v;
                    if (v > 0.0f) bx_mass[j] += v;
                }
            }
        }
        for (int64_t j = 0; j < J; ++j) {
            box[f * J + j] = bx_mass[j];
            total[f * J + j] = tot[j];
        }
    }
}
