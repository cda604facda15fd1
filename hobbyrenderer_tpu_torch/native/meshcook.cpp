// Native mesh-cooking kernels (the meshoptimizer role in the reference:
// meshopt_buildMeshlets et al., used by SceneLoader::ProcessMeshes,
// src/SceneLoader.cpp:2055-2108).
//
// The greedy meshlet scan is inherently sequential per primitive (a running
// vertex-set under budget constraints), which makes it the one cook stage that
// cannot be vectorized with numpy — so it lives here as C++ invoked via ctypes
// (hobbyrenderer_tpu_torch/native/build.py). The Python implementation in
// scene/cooker.py remains as the portable fallback and as the reference for
// the equality test (tests/test_native.py).

#include <cstdint>
#include <cstring>

extern "C" {

// Greedy meshlet build over pre-ordered triangles (caller provides spatial
// ordering, e.g. Morton). Outputs are caller-allocated at worst case:
//   ml_vert_offset/ml_vert_count/ml_tri_offset/ml_tri_count: n_tris entries
//   ml_vertices: n_tris * 3 entries, ml_tris: n_tris * 3 entries (local idx)
// Returns the number of meshlets.
int build_meshlets(const int32_t* tris,      // (n_tris, 3) vertex indices
                   int32_t n_tris,
                   int32_t n_verts,
                   int32_t max_verts,        // 64 (ref Common.sr:53-55)
                   int32_t max_tris,         // 96
                   int32_t* ml_vert_offset,
                   int32_t* ml_vert_count,
                   int32_t* ml_tri_offset,
                   int32_t* ml_tri_count,
                   int32_t* ml_vertices,     // global vertex ids
                   int32_t* ml_tris)         // meshlet-local triples
{
    // vertex -> local slot map for the CURRENT meshlet; 0xFFFFFFFF = absent
    int32_t* slot = new int32_t[n_verts];
    memset(slot, 0xFF, sizeof(int32_t) * n_verts);

    int n_meshlets = 0;
    int cur_v = 0;          // vertices in current meshlet
    int cur_t = 0;          // triangles in current meshlet
    int out_v = 0;          // total emitted meshlet-vertices
    int out_t = 0;          // total emitted meshlet-triangles

    int cur_vstart = 0;
    int cur_tstart = 0;

    auto flush = [&]() {
        if (cur_t == 0) return;
        ml_vert_offset[n_meshlets] = cur_vstart;
        ml_vert_count[n_meshlets] = cur_v;
        ml_tri_offset[n_meshlets] = cur_tstart;
        ml_tri_count[n_meshlets] = cur_t;
        n_meshlets++;
        // reset the slot map for the vertices we used
        for (int i = cur_vstart; i < cur_vstart + cur_v; ++i)
            slot[ml_vertices[i]] = -1;
        cur_vstart = out_v;
        cur_tstart = out_t;
        cur_v = 0;
        cur_t = 0;
    };

    for (int t = 0; t < n_tris; ++t) {
        const int32_t a = tris[t * 3 + 0];
        const int32_t b = tris[t * 3 + 1];
        const int32_t c = tris[t * 3 + 2];
        int fresh = (slot[a] < 0) + (slot[b] < 0) + (slot[c] < 0);
        if (cur_v + fresh > max_verts || cur_t + 1 > max_tris) {
            flush();
            fresh = 3;
        }
        int32_t local[3];
        const int32_t v3[3] = {a, b, c};
        for (int k = 0; k < 3; ++k) {
            if (slot[v3[k]] < 0) {
                slot[v3[k]] = cur_v;
                ml_vertices[cur_vstart + cur_v] = v3[k];
                cur_v++;
                out_v++;
            }
            local[k] = slot[v3[k]];
        }
        ml_tris[out_t * 3 + 0] = local[0];
        ml_tris[out_t * 3 + 1] = local[1];
        ml_tris[out_t * 3 + 2] = local[2];
        out_t++;
        cur_t++;
    }
    flush();

    delete[] slot;
    return n_meshlets;
}

// Vertex-cache-friendly triangle reordering by centroid Morton code is done in
// numpy (vectorized); no native counterpart needed.

}  // extern "C"

// ---------------------------------------------------------------------------
// Quadric-error-metric LOD simplification (the meshopt_simplifyWithAttributes
// role, ref src/SceneLoader.cpp:1995-2044).
//
// Garland-Heckbert error quadrics with endpoint placement (collapses move a
// vertex ONTO an existing neighbor, so per-vertex attributes — uv/normal/
// tangent wedges — survive untouched), border/seam preservation via
// perpendicular constraint quadrics on open edges (positional UV seams are
// open edges in wedge space, so both seam curves are constrained alike), a
// triangle-flip rejection test, and pass-based greedy acceptance (cost-sorted
// candidate edges, each vertex touched at most once per pass) — the same
// structure meshoptimizer uses instead of an incremental heap.
// ---------------------------------------------------------------------------

#include <algorithm>
#include <cmath>
#include <vector>

namespace {

struct Quadric {
    // symmetric 4x4: [a2 ab ac ad; . b2 bc bd; . . c2 cd; . . . d2]
    double a2, ab, ac, ad, b2, bc, bd, c2, cd, d2;
    void zero() { a2 = ab = ac = ad = b2 = bc = bd = c2 = cd = d2 = 0.0; }
    void add(const Quadric& q) {
        a2 += q.a2; ab += q.ab; ac += q.ac; ad += q.ad;
        b2 += q.b2; bc += q.bc; bd += q.bd;
        c2 += q.c2; cd += q.cd; d2 += q.d2;
    }
    void from_plane(double a, double b, double c, double d, double w) {
        a2 = w * a * a; ab = w * a * b; ac = w * a * c; ad = w * a * d;
        b2 = w * b * b; bc = w * b * c; bd = w * b * d;
        c2 = w * c * c; cd = w * c * d; d2 = w * d * d;
    }
    double eval(double x, double y, double z) const {
        return a2 * x * x + 2 * ab * x * y + 2 * ac * x * z + 2 * ad * x
             + b2 * y * y + 2 * bc * y * z + 2 * bd * y
             + c2 * z * z + 2 * cd * z + d2;
    }
};

inline void cross3(const double* u, const double* v, double* out) {
    out[0] = u[1] * v[2] - u[2] * v[1];
    out[1] = u[2] * v[0] - u[0] * v[2];
    out[2] = u[0] * v[1] - u[1] * v[0];
}

}  // namespace

extern "C" {

// Simplify toward target_tris. positions (n_verts, 3) f32; tris (n_tris, 3)
// i32 (wedge-space indices, already degenerate-filtered). error_limit is the
// max allowed POSITION error (object units) for any collapse. Outputs:
// out_tris (caller cap n_tris) receives the simplified triangle list; returns
// its count; *out_error receives the max accepted collapse error (object
// units, conservative LOD-select metric).
int simplify_qem(const float* positions, int32_t n_verts,
                 const int32_t* tris, int32_t n_tris,
                 int32_t target_tris, float error_limit,
                 int32_t* out_tris, float* out_error)
{
    std::vector<int32_t> cur(tris, tris + (size_t)n_tris * 3);
    std::vector<int32_t> remap(n_verts);
    for (int i = 0; i < n_verts; ++i) remap[i] = i;
    double max_err = 0.0;
    const double limit2 = (double)error_limit * (double)error_limit;

    std::vector<Quadric> vq(n_verts);
    std::vector<uint8_t> touched(n_verts);
    std::vector<int32_t> adj_off(n_verts + 1), adj_cnt(n_verts);
    std::vector<int32_t> adj;  // vertex -> incident triangle ids (CSR)

    struct Cand { double cost; int32_t a, b; };
    std::vector<Cand> cands;
    std::vector<std::pair<int64_t, int32_t>> edge_keys;  // (key, tri)

    for (int pass = 0; pass < 64; ++pass) {
        int nt = (int)cur.size() / 3;
        if (nt <= target_tris) break;

        // ---- per-vertex quadrics from face planes (area-weighted) ----
        for (auto& q : vq) q.zero();
        for (int t = 0; t < nt; ++t) {
            const int32_t i0 = cur[t * 3], i1 = cur[t * 3 + 1],
                          i2 = cur[t * 3 + 2];
            const float* p0 = positions + (size_t)i0 * 3;
            const float* p1 = positions + (size_t)i1 * 3;
            const float* p2 = positions + (size_t)i2 * 3;
            double e1[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
            double e2[3] = {p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2]};
            double nrm[3];
            cross3(e1, e2, nrm);
            double len = std::sqrt(nrm[0] * nrm[0] + nrm[1] * nrm[1]
                                   + nrm[2] * nrm[2]);
            if (len < 1e-30) continue;
            double area = 0.5 * len;
            double inv = 1.0 / len;
            double a = nrm[0] * inv, b = nrm[1] * inv, c = nrm[2] * inv;
            double d = -(a * p0[0] + b * p0[1] + c * p0[2]);
            Quadric q;
            q.from_plane(a, b, c, d, area);
            vq[i0].add(q); vq[i1].add(q); vq[i2].add(q);

            // border detection input: undirected edge keys
        }

        // ---- open-edge constraint quadrics (border/seam preservation) ----
        edge_keys.clear();
        edge_keys.reserve((size_t)nt * 3);
        for (int t = 0; t < nt; ++t) {
            for (int k = 0; k < 3; ++k) {
                int32_t u = cur[t * 3 + k], v = cur[t * 3 + (k + 1) % 3];
                int64_t lo = u < v ? u : v, hi = u < v ? v : u;
                edge_keys.push_back({(lo << 32) | hi, t});
            }
        }
        std::sort(edge_keys.begin(), edge_keys.end(),
                  [](const auto& x, const auto& y) { return x.first < y.first; });
        // adjacency CSR (vertex -> triangles) built in the same pass
        std::fill(adj_cnt.begin(), adj_cnt.end(), 0);
        for (int t = 0; t < nt; ++t)
            for (int k = 0; k < 3; ++k) adj_cnt[cur[t * 3 + k]]++;
        adj_off[0] = 0;
        for (int i = 0; i < n_verts; ++i) adj_off[i + 1] = adj_off[i] + adj_cnt[i];
        adj.assign(adj_off[n_verts], 0);
        std::fill(adj_cnt.begin(), adj_cnt.end(), 0);
        for (int t = 0; t < nt; ++t)
            for (int k = 0; k < 3; ++k) {
                int32_t v = cur[t * 3 + k];
                adj[adj_off[v] + adj_cnt[v]++] = t;
            }

        for (size_t i = 0; i < edge_keys.size();) {
            size_t j = i;
            while (j < edge_keys.size() && edge_keys[j].first == edge_keys[i].first)
                ++j;
            if (j - i == 1) {  // open edge: add perpendicular constraint plane
                int32_t u = (int32_t)(edge_keys[i].first >> 32);
                int32_t v = (int32_t)(edge_keys[i].first & 0x7FFFFFFF);
                const float* pu = positions + (size_t)u * 3;
                const float* pv = positions + (size_t)v * 3;
                int t = edge_keys[i].second;
                const int32_t i0 = cur[t * 3], i1 = cur[t * 3 + 1],
                              i2 = cur[t * 3 + 2];
                const float* p0 = positions + (size_t)i0 * 3;
                const float* p1 = positions + (size_t)i1 * 3;
                const float* p2 = positions + (size_t)i2 * 3;
                double e1[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
                double e2[3] = {p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2]};
                double fn[3];
                cross3(e1, e2, fn);
                double ed[3] = {pv[0] - pu[0], pv[1] - pu[1], pv[2] - pu[2]};
                double cp[3];
                cross3(ed, fn, cp);  // perpendicular to edge, in face "plane"
                double len = std::sqrt(cp[0] * cp[0] + cp[1] * cp[1]
                                       + cp[2] * cp[2]);
                double elen2 = ed[0] * ed[0] + ed[1] * ed[1] + ed[2] * ed[2];
                if (len > 1e-30) {
                    double inv = 1.0 / len;
                    double a = cp[0] * inv, b = cp[1] * inv, c = cp[2] * inv;
                    double d = -(a * pu[0] + b * pu[1] + c * pu[2]);
                    Quadric q;
                    q.from_plane(a, b, c, d, elen2);  // strong: edge-len^2 weight
                    vq[u].add(q);
                    vq[v].add(q);
                }
            }
            i = j;
        }

        // ---- candidate half-edges: cost of moving a onto b ----
        cands.clear();
        for (size_t i = 0; i < edge_keys.size();) {
            size_t j = i;
            while (j < edge_keys.size() && edge_keys[j].first == edge_keys[i].first)
                ++j;
            int32_t u = (int32_t)(edge_keys[i].first >> 32);
            int32_t v = (int32_t)(edge_keys[i].first & 0x7FFFFFFF);
            const float* pu = positions + (size_t)u * 3;
            const float* pv = positions + (size_t)v * 3;
            double cu = vq[u].eval(pv[0], pv[1], pv[2]);  // move u -> v
            double cv = vq[v].eval(pu[0], pu[1], pu[2]);  // move v -> u
            if (cu <= limit2) cands.push_back({cu, u, v});
            if (cv <= limit2) cands.push_back({cv, v, u});
            i = j;
        }
        std::sort(cands.begin(), cands.end(),
                  [](const Cand& x, const Cand& y) { return x.cost < y.cost; });

        // ---- greedy acceptance with flip rejection ----
        std::fill(touched.begin(), touched.end(), 0);
        int want = nt - target_tris;  // triangles still to remove
        int accepted = 0;
        for (const Cand& cd : cands) {
            if (want <= 0) break;
            if (touched[cd.a] || touched[cd.b]) continue;
            const float* pa = positions + (size_t)cd.a * 3;
            const float* pb = positions + (size_t)cd.b * 3;
            // flip test: every triangle around a that survives (doesn't
            // contain b) must keep its orientation when a moves to b's pos
            bool ok = true;
            for (int s = adj_off[cd.a]; s < adj_off[cd.a + 1] && ok; ++s) {
                int t = adj[s];
                int32_t w[3] = {cur[t * 3], cur[t * 3 + 1], cur[t * 3 + 2]};
                if (w[0] == cd.b || w[1] == cd.b || w[2] == cd.b) continue;
                double q0[3], q1[3], q2[3];
                const float* src[3];
                for (int k = 0; k < 3; ++k)
                    src[k] = (w[k] == cd.a) ? pb
                           : positions + (size_t)w[k] * 3;
                for (int k = 0; k < 3; ++k) {
                    q0[k] = positions[(size_t)w[0] * 3 + k];
                    q1[k] = positions[(size_t)w[1] * 3 + k];
                    q2[k] = positions[(size_t)w[2] * 3 + k];
                }
                double b4[3] = {q1[0] - q0[0], q1[1] - q0[1], q1[2] - q0[2]};
                double c4[3] = {q2[0] - q0[0], q2[1] - q0[1], q2[2] - q0[2]};
                double n_before[3];
                cross3(b4, c4, n_before);
                double a4[3] = {src[1][0] - src[0][0], src[1][1] - src[0][1],
                                src[1][2] - src[0][2]};
                double d4[3] = {src[2][0] - src[0][0], src[2][1] - src[0][1],
                                src[2][2] - src[0][2]};
                double n_after[3];
                cross3(a4, d4, n_after);
                double dot = n_before[0] * n_after[0] + n_before[1] * n_after[1]
                           + n_before[2] * n_after[2];
                if (dot <= 0.0) ok = false;
            }
            if (!ok) continue;
            (void)pa;
            remap[cd.a] = cd.b;
            touched[cd.a] = touched[cd.b] = 1;
            if (cd.cost > max_err) max_err = cd.cost;
            // each interior collapse removes ~2 triangles
            want -= 2;
            accepted++;
        }
        if (accepted == 0) break;

        // ---- apply remap (path-compress), drop degenerates ----
        for (int i = 0; i < n_verts; ++i) {
            int32_t r = remap[i];
            while (remap[r] != r) r = remap[r];
            remap[i] = r;
        }
        size_t w = 0;
        for (int t = 0; t < nt; ++t) {
            int32_t a = remap[cur[t * 3]], b = remap[cur[t * 3 + 1]],
                    c = remap[cur[t * 3 + 2]];
            if (a == b || b == c || a == c) continue;
            cur[w * 3] = a; cur[w * 3 + 1] = b; cur[w * 3 + 2] = c;
            ++w;
        }
        cur.resize(w * 3);
    }

    int out_n = (int)cur.size() / 3;
    memcpy(out_tris, cur.data(), cur.size() * sizeof(int32_t));
    *out_error = (float)std::sqrt(max_err);
    return out_n;
}

}  // extern "C"
