// Procedural textures in device code: the texture part of K1-ext.
//
// Replaces raytrace_tpu/ops/megakernel.py:_tex_value_comp (:190), bound in
// the bounce body at :1967-1980. The plain version is
// raytrace_tpu_torch/models/textures.py (a port of the JAX package's
// models/textures.py); each field below repeats its float32 operations in
// its order, so a texture differs from it only where the library sinf or
// powf rounds differently from PyTorch's (CUDA's own sinf/powf on the
// card). The kernel evaluates only the binding of the hit's material.
//
// Texture table (texture_rows), one row of kTexCols floats per binding:
//   [0] material index, [1] type, then by type:
//   0 checkerboard  scale, color1.rgb, color2.rgb
//   1 marble        scale, sharpness, base.rgb, vein.rgb
//   2 wood          scale, ring_width, base.rgb, ring.rgb
//   3 gradient      unit direction.xyz, color1.rgb, color2.rgb
//   4 noise         scale, octaves, seed, norm, amplitude, aux offset
//   5 perlin        the same, amplitude 1 (not applied)
//   6 voronoi       scale, distance type, aux offset, point count
// and aux rows of 3 floats: an fbm octave's (weight, frequency, 0), or a
// Voronoi feature point.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int kTexCols = 16;

// fastmath._hash_to_unit: pcg4d of the lattice point, top 24 bits.
RT_DEV float hash_to_unit(uint32_t ix, uint32_t iy, uint32_t iz,
                          uint32_t seed) {
  uint32_t x = ix, y = iy, z = iz, w = seed;
  pcg4d(x, y, z, w);
  return static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
}

RT_DEV float smooth01(float t) { return t * t * (3.0f - 2.0f * t); }

RT_DEV float lerp1(float a, float b, float t) { return a + (b - a) * t; }

// fastmath.fast_noise_3d: smoothed value noise on the integer lattice.
RT_DEV float noise3(float x, float y, float z, uint32_t seed) {
  float fx0 = floorf(x), fy0 = floorf(y), fz0 = floorf(z);
  float fx = x - fx0, fy = y - fy0, fz = z - fz0;
  uint32_t ix = static_cast<uint32_t>(static_cast<int>(fx0));
  uint32_t iy = static_cast<uint32_t>(static_cast<int>(fy0));
  uint32_t iz = static_cast<uint32_t>(static_cast<int>(fz0));
  float sx = smooth01(fx), sy = smooth01(fy), sz = smooth01(fz);
  float c00 = lerp1(hash_to_unit(ix, iy, iz, seed),
                    hash_to_unit(ix + 1u, iy, iz, seed), sx);
  float c10 = lerp1(hash_to_unit(ix, iy + 1u, iz, seed),
                    hash_to_unit(ix + 1u, iy + 1u, iz, seed), sx);
  float c01 = lerp1(hash_to_unit(ix, iy, iz + 1u, seed),
                    hash_to_unit(ix + 1u, iy, iz + 1u, seed), sx);
  float c11 = lerp1(hash_to_unit(ix, iy + 1u, iz + 1u, seed),
                    hash_to_unit(ix + 1u, iy + 1u, iz + 1u, seed), sx);
  return lerp1(lerp1(c00, c10, sy), lerp1(c01, c11, sy), sz);
}

// fastmath.fbm_3d with the octave weights and frequencies from aux.
RT_DEV float fbm3(float x, float y, float z, int octaves, uint32_t seed,
                  float norm, const float* aux) {
  float total = 0.0f;
  for (int o = 0; o < octaves; ++o) {
    float amp = aux[3 * o], freq = aux[3 * o + 1];
    total = total + amp * noise3(x * freq, y * freq, z * freq,
                                 seed + static_cast<uint32_t>(o));
  }
  return total / norm;
}

// torch.pow(v, e) for a Python-float exponent: PyTorch computes e == 2 and
// e == 3 as products and e == 0.5 as a square root.
RT_DEV float pow_scalar(float v, float e) {
  if (e == 2.0f) return v * v;
  if (e == 3.0f) return v * v * v;
  if (e == 0.5f) return sqrtf(v);
  return powf(v, e);
}

RT_DEV V3 lerp_color(const float* c1, const float* c2, float t) {
  return V3{c1[0] * (1.0f - t) + c2[0] * t, c1[1] * (1.0f - t) + c2[1] * t,
            c1[2] * (1.0f - t) + c2[2] * t};
}

// The albedo at hit point p of material mid: a colour texture replaces
// alb, a scalar field scales it (textures.textured_albedo); eff takes the
// same value. Materials without a binding keep both.
RT_DEV void apply_texture(const float* tex, int ntex, const float* aux,
                          int mid, V3 p, V3* alb, V3* eff) {
  for (int i = 0; i < ntex; ++i) {
    const float* t = tex + kTexCols * i;
    if (static_cast<int>(t[0]) != mid) continue;
    const int type = static_cast<int>(t[1]);
    const float* q = t + 2;
    V3 c;
    if (type == 0) {
      float s = q[0];
      float checker = floorf(p.x * s) + floorf(p.y * s) + floorf(p.z * s);
      c = fmodf(checker, 2.0f) == 0.0f ? V3{q[1], q[2], q[3]}
                                       : V3{q[4], q[5], q[6]};
    } else if (type == 1) {
      float s = q[0];
      float v = sinf(p.x * s + p.y * s * 0.5f + p.z * s * 0.25f);
      v = (v + 1.0f) / 2.0f;
      c = lerp_color(q + 2, q + 5, pow_scalar(v, q[1]));
    } else if (type == 2) {
      float s = q[0];
      float ring = fabsf(sinf(p.x * s + p.y * s * 0.5f));
      c = lerp_color(q + 2, q + 5, ring < q[1] ? 1.0f : 0.0f);
    } else if (type == 3) {
      float tt = (p.x * q[0] + p.y * q[1] + p.z * q[2] + 1.0f) / 2.0f;
      c = lerp_color(q + 3, q + 6, tt);
    } else {
      float s = q[0];
      float v;
      if (type == 6) {
        const float* fp = aux + 3 * static_cast<int>(q[2]);
        const int np = static_cast<int>(q[3]), dist = static_cast<int>(q[1]);
        float px = p.x * s, py = p.y * s, pz = p.z * s;
        v = kBig;
        for (int j = 0; j < np; ++j) {
          float dx = px - fp[3 * j], dy = py - fp[3 * j + 1],
                dz = pz - fp[3 * j + 2];
          float dj = dist == 1 ? fabsf(dx) + fabsf(dy) + fabsf(dz)
                   : dist == 2 ? fmaxf(fmaxf(fabsf(dx), fabsf(dy)), fabsf(dz))
                               : sqrtf(dx * dx + dy * dy + dz * dz);
          v = fminf(v, dj);
        }
      } else {
        v = fbm3(p.x * s, p.y * s, p.z * s, static_cast<int>(q[1]),
                 static_cast<uint32_t>(static_cast<int>(q[2])), q[3],
                 aux + 3 * static_cast<int>(q[5]));
        if (type == 4) v = v * q[4];
      }
      c = V3{alb->x * v, alb->y * v, alb->z * v};
    }
    *alb = c;
    *eff = c;
    return;
  }
}

}  // namespace rt
