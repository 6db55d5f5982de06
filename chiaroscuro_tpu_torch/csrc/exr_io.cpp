// Native EXR I/O shim over the system OpenEXR 3.1 C++ API.
//
// Plays the role of the reference's FreeImage HDR export path
// (src/rayTracer.cpp:225-279) plus golden-image *reading* (the reference
// goldens in renders/*.exr are HALF, PIZ-compressed — beyond a reasonable
// pure-Python decoder).  Exposed as a tiny C ABI for ctypes.
//
// Build: g++ at first use into _build/libexr_io_<hash>.so
// (render/image_io.py through ops/cuda_build.py::build_host_library, with
// -I/usr/include/OpenEXR -I/usr/include/Imath and the OpenEXR 3.1 libraries).

#include <ImfRgbaFile.h>
#include <ImfArray.h>
#include <ImfCompression.h>

#include <cstring>
#include <string>

using namespace Imf;
using namespace Imath;

extern "C" {

// Returns 0 on success; fills *w, *h with the data-window size.
int exr_get_size(const char *path, int *w, int *h) {
    try {
        RgbaInputFile file(path);
        Box2i dw = file.dataWindow();
        *w = dw.max.x - dw.min.x + 1;
        *h = dw.max.y - dw.min.y + 1;
        return 0;
    } catch (...) {
        return 1;
    }
}

// Reads RGB (converted from any channel layout via the Rgba interface) into
// out[h*w*3] in row-major top-down order.  Returns 0 on success.
int exr_read_rgb(const char *path, float *out) {
    try {
        RgbaInputFile file(path);
        Box2i dw = file.dataWindow();
        const int w = dw.max.x - dw.min.x + 1;
        const int h = dw.max.y - dw.min.y + 1;

        Array2D<Rgba> px(h, w);
        file.setFrameBuffer(&px[0][0] - dw.min.x - dw.min.y * w, 1, w);
        file.readPixels(dw.min.y, dw.max.y);

        for (int y = 0; y < h; ++y) {
            for (int x = 0; x < w; ++x) {
                const Rgba &p = px[y][x];
                float *o = out + 3 * (y * w + x);
                o[0] = p.r;
                o[1] = p.g;
                o[2] = p.b;
            }
        }
        return 0;
    } catch (...) {
        return 1;
    }
}

// Writes data[h*w*3] (row-major, top-down) as HALF RGB scanlines.
// compression: 0=NONE 2=ZIP 4=PIZ (matching Imf::Compression values; the
// reference goldens use PIZ).  Returns 0 on success.
int exr_write_rgb(const char *path, const float *data, int w, int h,
                  int compression) {
    try {
        Array2D<Rgba> px(h, w);
        for (int y = 0; y < h; ++y) {
            for (int x = 0; x < w; ++x) {
                const float *s = data + 3 * (y * w + x);
                px[y][x] = Rgba(s[0], s[1], s[2], 1.0f);
            }
        }
        Header header(w, h);
        header.compression() = static_cast<Compression>(compression);
        RgbaOutputFile file(path, header, WRITE_RGB);
        file.setFrameBuffer(&px[0][0], 1, w);
        file.writePixels(h);
        return 0;
    } catch (...) {
        return 1;
    }
}

}  // extern "C"
