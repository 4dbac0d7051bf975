// Native (C++) host runtime of the PyTorch port: the port's own copy of
// the JAX package's csrc/butd_native.cpp, whose code it keeps line for
// line, so that both give the same bits on one machine.
//
// The device-side point ops are CUDA kernels (the other files here). What
// remains hot on the HOST are the data-loader and eval cold paths — this
// library accelerates those:
//   * binary PLY vertex parsing (ScanNet _vh_clean_2 files),
//   * greedy NMS over axis-aligned boxes (utils/nms.py semantics),
//   * the VOC-AP greedy matcher inner loop (utils/eval_det.py:162-260),
//   * the fused point-cloud augmentation pass,
//   * point-in-box containment counting (ap_helper remove_empty_box).
//
// Exposed as a plain C ABI consumed via ctypes
// (butd_detr_tpu_torch/native.py), which builds it at first use with
// `g++ -O3 -march=native -fPIC -shared -std=c++17 -Wall` (the flags of
// the JAX package's csrc/Makefile: the FMA contractions -march=native
// allows change the augmentation's last bits).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// PLY parsing
// ---------------------------------------------------------------------

// Parse the vertex element of a binary_little_endian PLY file.
// Fills xyz (n*3 float32), rgb (n*3 uint8, zeros if absent) and label
// (n int32, -1 if absent). Returns the vertex count, or -1 on error.
// Callers first ask for the count with ply_vertex_count, then allocate.
long ply_vertex_count(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char line[512];
  long count = -1;
  while (fgets(line, sizeof(line), f)) {
    if (strncmp(line, "element vertex", 14) == 0) {
      count = strtol(line + 14, nullptr, 10);
    } else if (strncmp(line, "end_header", 10) == 0) {
      break;
    }
  }
  fclose(f);
  return count;
}

long ply_read_vertices(const char* path, float* xyz, uint8_t* rgb,
                       int32_t* label) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;

  struct Prop {
    std::string name;
    int size;  // bytes
    char kind;  // f=float, i=int, u=uint, d=double
  };
  std::vector<Prop> props;
  long count = -1;
  bool little = true;
  char line[512];
  while (fgets(line, sizeof(line), f)) {
    if (strncmp(line, "format", 6) == 0) {
      little = strstr(line, "little") != nullptr;
      if (strstr(line, "ascii")) { fclose(f); return -2; }
    } else if (strncmp(line, "element vertex", 14) == 0) {
      count = strtol(line + 14, nullptr, 10);
    } else if (strncmp(line, "element", 7) == 0 && count >= 0 &&
               !props.empty()) {
      // a later element (e.g. faces) ends the vertex property list
      // keep scanning until end_header
    } else if (strncmp(line, "property", 8) == 0 && count >= 0) {
      char type[64], name[64];
      if (sscanf(line, "property %63s %63s", type, name) == 2 &&
          strcmp(type, "list") != 0) {
        Prop p;
        p.name = name;
        std::string t = type;
        if (t == "float" || t == "float32") { p.size = 4; p.kind = 'f'; }
        else if (t == "double" || t == "float64") { p.size = 8; p.kind = 'd'; }
        else if (t == "uchar" || t == "uint8" || t == "char" || t == "int8")
          { p.size = 1; p.kind = 'u'; }
        else if (t == "ushort" || t == "uint16" || t == "short" ||
                 t == "int16") { p.size = 2; p.kind = 'u'; }
        else { p.size = 4; p.kind = 'i'; }
        props.push_back(p);
      }
    } else if (strncmp(line, "end_header", 10) == 0) {
      break;
    }
  }
  if (count < 0 || !little) { fclose(f); return -3; }

  int stride = 0;
  for (auto& p : props) stride += p.size;
  std::vector<uint8_t> buf((size_t)count * stride);
  if (fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    fclose(f);
    return -4;
  }
  fclose(f);

  int off = 0;
  for (auto& p : props) {
    const uint8_t* base = buf.data() + off;
    if ((p.name == "x" || p.name == "y" || p.name == "z") && xyz) {
      int c = p.name[0] - 'x';
      if (p.kind == 'f' && p.size == 4) {
        for (long i = 0; i < count; ++i) {
          float v;
          memcpy(&v, base + (size_t)i * stride, 4);
          xyz[i * 3 + c] = v;
        }
      } else if (p.kind == 'd') {
        for (long i = 0; i < count; ++i) {
          double v;
          memcpy(&v, base + (size_t)i * stride, 8);
          xyz[i * 3 + c] = (float)v;
        }
      }
    } else if ((p.name == "red" || p.name == "green" || p.name == "blue")
               && rgb && p.size == 1) {
      int c = p.name == "red" ? 0 : (p.name == "green" ? 1 : 2);
      for (long i = 0; i < count; ++i)
        rgb[i * 3 + c] = base[(size_t)i * stride];
    } else if (p.name == "label" && label) {
      for (long i = 0; i < count; ++i) {
        uint32_t v = 0;
        memcpy(&v, base + (size_t)i * stride, p.size);
        label[i] = (int32_t)v;
      }
    }
    off += p.size;
  }
  return count;
}

// ---------------------------------------------------------------------
// Greedy NMS over axis-aligned d-dimensional boxes
// ---------------------------------------------------------------------

// mins/maxs: (n, d); scores: (n); classes: (n) or null.
// keep: out indices (caller allocates n). Returns kept count.
long greedy_nms(const float* mins, const float* maxs, const float* scores,
                const int32_t* classes, long n, int d, float thresh,
                int old_type, int32_t* keep) {
  std::vector<int32_t> order(n);
  for (long i = 0; i < n; ++i) order[i] = (int32_t)i;
  // score desc; ties broken by higher index first, matching the python
  // path's ascending argsort consumed from the back (utils/nms.py:53-57)
  std::stable_sort(order.begin(), order.end(),
                   [&](int32_t a, int32_t b) {
                     if (scores[a] != scores[b]) return scores[a] > scores[b];
                     return a > b;
                   });
  std::vector<float> area(n, 1.0f);
  for (long i = 0; i < n; ++i)
    for (int c = 0; c < d; ++c) area[i] *= maxs[i * d + c] - mins[i * d + c];

  std::vector<char> dead(n, 0);
  long k = 0;
  for (long oi = 0; oi < n; ++oi) {
    int32_t i = order[oi];
    if (dead[i]) continue;
    keep[k++] = i;
    for (long oj = oi + 1; oj < n; ++oj) {
      int32_t j = order[oj];
      if (dead[j]) continue;
      if (classes && classes[i] != classes[j]) continue;
      float inter = 1.0f;
      for (int c = 0; c < d; ++c) {
        float lo = std::max(mins[i * d + c], mins[j * d + c]);
        float hi = std::min(maxs[i * d + c], maxs[j * d + c]);
        inter *= std::max(0.0f, hi - lo);
        if (inter <= 0) break;
      }
      float o = old_type ? inter / area[j]
                         : inter / (area[i] + area[j] - inter);
      if (o > thresh) dead[j] = 1;
    }
  }
  return k;
}

// ---------------------------------------------------------------------
// VOC-AP greedy matching (single class)
// ---------------------------------------------------------------------

// Detections are pre-sorted by confidence desc. det_boxes: (nd, 6) AABB
// [min,max]; det_img: (nd) image ids. gt_boxes: (ng, 6); gt_img: (ng).
// tp/fp: out (nd) 0/1. Returns npos (= ng).
long voc_match(const float* det_boxes, const int32_t* det_img, long nd,
               const float* gt_boxes, const int32_t* gt_img, long ng,
               float ovthresh, uint8_t* tp, uint8_t* fp) {
  std::vector<char> claimed(ng, 0);
  for (long di = 0; di < nd; ++di) {
    const float* b = det_boxes + di * 6;
    float vb = (b[3] - b[0]) * (b[4] - b[1]) * (b[5] - b[2]);
    float ovmax = -1.0f;
    long jmax = -1;
    for (long gi = 0; gi < ng; ++gi) {
      if (gt_img[gi] != det_img[di]) continue;
      const float* g = gt_boxes + gi * 6;
      float inter = 1.0f;
      for (int c = 0; c < 3; ++c) {
        float lo = std::max(b[c], g[c]);
        float hi = std::min(b[c + 3], g[c + 3]);
        inter *= std::max(0.0f, hi - lo);
      }
      float vg = (g[3] - g[0]) * (g[4] - g[1]) * (g[5] - g[2]);
      float iou = inter / (vb + vg - inter);
      if (iou > ovmax) { ovmax = iou; jmax = gi; }
    }
    if (jmax >= 0 && ovmax > ovthresh && !claimed[jmax]) {
      tp[di] = 1;
      fp[di] = 0;
      claimed[jmax] = 1;
    } else {
      tp[di] = 0;
      fp[di] = 1;
    }
  }
  return ng;
}

// ---------------------------------------------------------------------
// Point-in-AABB counting (remove_empty_box)
// ---------------------------------------------------------------------

// ---------------------------------------------------------------------
// Fused point-cloud augmentation (data-loader hot path)
// ---------------------------------------------------------------------

// One pass over n points applying the reference's _augment chain
// (joint_det_dataset.py:358-403) with flips+rotations pre-folded into a
// single 3x3 matrix M (row-major; built f64 on the python side):
//   xyz' = (M @ xyz + noise[i] + shift) * scale
// and, when color != null,
//   color' = (color + mean) * cscale[i] - mean.
// pc rows are `stride` floats apart (xyz in the first 3). The numpy
// fallback applies the same ops as separate passes; results agree to f32
// rounding (the matmul association differs), which is already within the
// documented f32-vs-reference-f64 augmentation tolerance.
void augment_fused(float* pc, long n, long stride, const float* M,
                   const float* noise, const float* shift, float scale,
                   float* color, const float* cscale, const float* mean) {
  for (long i = 0; i < n; ++i) {
    float* p = pc + i * stride;
    const float x = p[0], y = p[1], z = p[2];
    const float* nz = noise + i * 3;
    for (int r = 0; r < 3; ++r) {
      p[r] = (M[r * 3] * x + M[r * 3 + 1] * y + M[r * 3 + 2] * z + nz[r] +
              shift[r]) * scale;
    }
  }
  if (color) {
    for (long i = 0; i < n; ++i) {
      float* c = color + i * 3;
      const float* cs = cscale + i * 3;
      for (int r = 0; r < 3; ++r)
        c[r] = (c[r] + mean[r]) * cs[r] - mean[r];
    }
  }
}

// points: (n, 3); boxes: (k, 6) AABB. counts: out (k).
void points_in_boxes(const float* points, long n, const float* boxes,
                     long k, int32_t* counts) {
  for (long b = 0; b < k; ++b) {
    const float* box = boxes + b * 6;
    int32_t cnt = 0;
    for (long i = 0; i < n; ++i) {
      const float* p = points + i * 3;
      if (p[0] >= box[0] && p[0] <= box[3] && p[1] >= box[1] &&
          p[1] <= box[4] && p[2] >= box[2] && p[2] <= box[5])
        ++cnt;
    }
    counts[b] = cnt;
  }
}

}  // extern "C"
