// The port's host voxelizer: one C++ pass from a point cloud to the dense
// occupancy and label volumes of one sample.
//
// Per point, in input order:
//   1. optionally a 3x4 affine (the rotation augmentation), each coordinate
//      truncated toward zero as numpy's int cast does
//      (data/geometry.py rotate_points), then the cloud re-translated so
//      that its minimum is the origin (data/geometry.py augment_points);
//   2. points outside [0, sx) x [0, sy) x [0, sz) are skipped;
//   3. the rest are scattered: occupancy 1.0, label = the point's label; a
//      later point overwrites an earlier one on the same voxel, as torch's
//      index assignment does in the reference.
// Every other voxel is occupancy 0 and label ``background``.
//
// Built with g++ at first use (runtime/__init__.py) and bound with ctypes,
// which releases the GIL for the call. One thread per call; the input
// pipeline runs it in its prefetch thread.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>

extern "C" {

// bck:        n x 3 int64 coordinates (already at the origin unless
//             affine is given)
// affine:     nullptr or 12 doubles, a row-major 3x4 transform
// labels:     n int32 label ids
// vol_in:     sx*sy*sz floats, written (occupancy)
// vol_lb:     sx*sy*sz int32, written (labels)
// out_coords: n x 3 int64 scratch for the transformed coordinates (read
//             only when affine is given)
// Returns the number of points scattered (in bounds).
int64_t unetsulc_voxelize(
    const int64_t* bck,
    const double* affine,
    const int32_t* labels,
    int64_t n,
    int64_t sx, int64_t sy, int64_t sz,
    int32_t background,
    float* vol_in,
    int32_t* vol_lb,
    int64_t* out_coords)
{
    const int64_t vol = sx * sy * sz;
    std::memset(vol_in, 0, sizeof(float) * vol);
    std::fill(vol_lb, vol_lb + vol, background);

    int64_t lo[3] = {0, 0, 0};
    const int64_t* pts = bck;
    if (affine != nullptr) {
        lo[0] = lo[1] = lo[2] = std::numeric_limits<int64_t>::max();
        for (int64_t i = 0; i < n; ++i) {
            const double p[3] = {(double)bck[i * 3 + 0], (double)bck[i * 3 + 1],
                                 (double)bck[i * 3 + 2]};
            for (int a = 0; a < 3; ++a) {
                const double* r = affine + a * 4;
                const double v = r[0] * p[0] + r[1] * p[1] + r[2] * p[2] + r[3];
                const int64_t iv = (int64_t)v;  // toward zero
                out_coords[i * 3 + a] = iv;
                lo[a] = std::min(lo[a], iv);
            }
        }
        if (n == 0) lo[0] = lo[1] = lo[2] = 0;
        pts = out_coords;
    }

    int64_t scattered = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t x = pts[i * 3 + 0] - lo[0];
        const int64_t y = pts[i * 3 + 1] - lo[1];
        const int64_t z = pts[i * 3 + 2] - lo[2];
        if (x < 0 || y < 0 || z < 0 || x >= sx || y >= sy || z >= sz) continue;
        const int64_t off = (x * sy + y) * sz + z;
        vol_in[off] = 1.0f;
        vol_lb[off] = labels[i];
        ++scattered;
    }
    return scattered;
}

}  // extern "C"
