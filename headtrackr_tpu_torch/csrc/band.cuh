// The rect and band rules of the camshift kernels, shared by histpdf.cu
// (the handoff histogram, the band pdf and the band backprojection),
// meanshift.cu (the band's origin in the frame) and handoff.cu (the
// handoff's histogram and its band audit), so that every kernel clamps a
// rect and places a band as the Python side does:
//   - clamped_rect: a detection rect [x, y, w, h] clamped to the frame
//     (ops/histogram.py hist4096_plain's ``_inside``);
//   - place_band: models/camshift.py band_rect, the one placement rule of
//     the band (8-aligned starts centred on the clamped window, clipped to
//     the frame).  The band kernels take each stream's search window and
//     place its band themselves, one placement a CTA, so the host computes
//     no origin.
// Header only; each .cu that includes it builds on its own.

#pragma once

#include <cstdint>

namespace band {

// A rect in the frame: origin (x0, y0), size rw x rh.
struct Rect {
  int64_t x0, y0, rw, rh;
};

__host__ __device__ __forceinline__ Rect clamped_rect(const int32_t* r, int h,
                                                      int w) {
  const int64_t rx = r[0], ry = r[1];
  const int64_t x0 = rx > 0 ? rx : 0;
  const int64_t y0 = ry > 0 ? ry : 0;
  int64_t x1 = rx + r[2];
  int64_t y1 = ry + r[3];
  x1 = x1 < w ? x1 : w;
  y1 = y1 < h ? y1 : h;
  return {x0, y0, x1 > x0 ? x1 - x0 : 0, y1 > y0 ? y1 - y0 : 0};
}

__host__ __device__ __forceinline__ int32_t floor_div2(int32_t v) {
  return v >= 0 ? v / 2 : -((1 - v) / 2);
}

__host__ __device__ __forceinline__ int32_t clip(int32_t v, int32_t lo,
                                                 int32_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// models/camshift.py band_rect for the window [x, y, w, h]: the band
// (min(bh, h) x min(bw, w)) whose 8-aligned origin is centred on the window
// clamped to the frame, clipped into it; i32 arithmetic as the twin's.
__host__ __device__ __forceinline__ Rect place_band(const int32_t* win, int h,
                                                    int w, int bh, int bw) {
  bh = bh < h ? bh : h;
  bw = bw < w ? bw : w;
  const int32_t cx = clip(win[0], 0, w) + floor_div2(win[2]);
  const int32_t cy = clip(win[1], 0, h) + floor_div2(win[3]);
  const int32_t rx = clip((cx - bw / 2) & ~7, 0, w - bw);
  const int32_t ry = clip((cy - bh / 2) & ~7, 0, h - bh);
  return {rx, ry, bw, bh};
}

}  // namespace band
