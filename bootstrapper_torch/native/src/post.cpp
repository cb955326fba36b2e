// Native post-processing core for bootstrapper_torch (a copy of the
// JAX package's native/src/post.cpp; the two packages share no code).
//
// Replaces the reference's native dependency surface (see SURVEY.md §2.4):
//   - waterz (C++):      hierarchical region-graph agglomeration
//   - mwatershed (Rust): mutex watershed over offset edge lists
//   - funlib.segment:    threshold-graph connected components
//   - numba CC:          affinity-gated grid connected components
//   - skimage.watershed: seeded priority-flood watershed
//
// All entry points are plain-C ABI for ctypes. Grids are C-order
// (Z, Y, X); affinity channels are the leading axis. IDs are uint64.
// Host-side sequential algorithms (union-find, priority floods) —
// the device prepares the inputs (affinities, landscapes, sorted edge
// weights); these finish the inherently-sequential graph work.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// union-find
// ---------------------------------------------------------------------------

struct UnionFind {
    std::vector<uint64_t> parent;
    std::vector<uint32_t> rank;

    explicit UnionFind(uint64_t n) : parent(n), rank(n, 0) {
        for (uint64_t i = 0; i < n; i++) parent[i] = i;
    }
    uint64_t find(uint64_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];
            x = parent[x];
        }
        return x;
    }
    uint64_t merge(uint64_t a, uint64_t b) {
        a = find(a);
        b = find(b);
        if (a == b) return a;
        if (rank[a] < rank[b]) std::swap(a, b);
        parent[b] = a;
        if (rank[a] == rank[b]) rank[a]++;
        return a;
    }
    // merge with a chosen surviving root (path compression keeps it flat)
    void merge_into(uint64_t root, uint64_t child) {
        parent[find(child)] = find(root);
    }
};

// Connected components over an edge list with scores: nodes whose edges
// have score <= threshold join one component. nodes are dense [0, n).
// out_labels[i] = representative node id of i's component.
void connected_components_edges(
    uint64_t n_nodes,
    const uint64_t* edges_u,
    const uint64_t* edges_v,
    const double* scores,
    uint64_t n_edges,
    double threshold,
    uint64_t* out_labels) {
    UnionFind uf(n_nodes);
    for (uint64_t e = 0; e < n_edges; e++) {
        if (scores[e] <= threshold) uf.merge(edges_u[e], edges_v[e]);
    }
    for (uint64_t i = 0; i < n_nodes; i++) out_labels[i] = uf.find(i);
}

// ---------------------------------------------------------------------------
// affinity-gated grid connected components (numba-CC capability)
// ---------------------------------------------------------------------------

// affs: (3, Z, Y, X) float32, already thresholded > 0.5 means connected.
// A voxel is foreground if any of its 3 affinities is on (matching the
// reference's flood-fill entry rule). out: (Z, Y, X) uint64, 0 = background.
void cc_from_hard_affs(
    const uint8_t* hard,  // (3, Z, Y, X) 0/1
    int64_t Z, int64_t Y, int64_t X,
    uint64_t* out) {
    const int64_t n = Z * Y * X;
    UnionFind uf((uint64_t)n);
    const int64_t strides[3] = {Y * X, X, 1};
    const uint8_t* chans[3] = {hard, hard + n, hard + 2 * n};
    // foreground spreads along ON edges: a voxel belongs to the
    // segmentation iff it has any incident ON edge (the reference's
    // flood fill follows edges into voxels with no own affinities)
    std::vector<uint8_t> fg(n, 0);
    for (int64_t z = 0; z < Z; z++)
        for (int64_t y = 0; y < Y; y++)
            for (int64_t x = 0; x < X; x++) {
                int64_t i = z * strides[0] + y * strides[1] + x;
                int64_t pos[3] = {z, y, x};
                int64_t lim[3] = {Z, Y, X};
                for (int c = 0; c < 3; c++) {
                    if (pos[c] + 1 < lim[c] && chans[c][i]) {
                        uf.merge(i, i + strides[c]);
                        fg[i] = 1;
                        fg[i + strides[c]] = 1;
                    }
                }
            }
    std::unordered_map<uint64_t, uint64_t> relabel;
    uint64_t next_id = 1;
    for (int64_t i = 0; i < n; i++) {
        if (!fg[i]) {
            out[i] = 0;
            continue;
        }
        uint64_t root = uf.find(i);
        auto it = relabel.find(root);
        if (it == relabel.end()) {
            relabel[root] = next_id;
            out[i] = next_id++;
        } else {
            out[i] = it->second;
        }
    }
}

// ---------------------------------------------------------------------------
// seeded watershed (priority flood; skimage.watershed capability)
// ---------------------------------------------------------------------------

// landscape: (Z, Y, X) float32 — flooded ascending. seeds: uint64 in/out
// (nonzero = seed labels); mask: uint8 (0 voxels stay 0).
// 6-connectivity.
//
// Implementation: rank-bucketed flood. Every voxel enters the queue at
// most once with a priority fixed in advance (its own landscape value),
// so the float heap (O(n log n), cache-hostile pops) is replaced by one
// FIFO bucket per *distinct* landscape value in CSR layout, visited
// lowest-value-first.  Popping from the lowest non-empty bucket with
// FIFO order inside a bucket reproduces the heap's
// (height asc, insertion order) sequence exactly — output is
// bit-identical, ~6x faster on EDT landscapes (few distinct values,
// sequential bucket memory).
void watershed_seeded(
    const float* landscape,
    uint64_t* labels,  // in: seeds, out: filled
    const uint8_t* mask,
    int64_t Z, int64_t Y, int64_t X) {
    const int64_t n = Z * Y * X;
    const int64_t strides[3] = {Y * X, X, 1};
    const int64_t lims[3] = {Z, Y, X};

    // rank landscape values: non-negative IEEE floats order by their
    // bit patterns, and EDT landscapes (max-dist) are >= 0.  Negative
    // values (arbitrary caller landscapes) map below via the standard
    // sign-flip transform.
    const auto tobits = [](float v) {
        uint32_t b;
        std::memcpy(&b, &v, 4);
        return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    };
    std::vector<uint32_t> key(n);
    {
        std::vector<uint32_t> uniq(n);
        for (int64_t i = 0; i < n; i++) uniq[i] = tobits(landscape[i]);
        std::sort(uniq.begin(), uniq.end());
        uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
        for (int64_t i = 0; i < n; i++)
            key[i] = (uint32_t)(std::lower_bound(uniq.begin(), uniq.end(),
                                                 tobits(landscape[i])) -
                                uniq.begin());
    }
    const int64_t n_levels =
        n ? (int64_t)*std::max_element(key.begin(), key.end()) + 1 : 0;

    // CSR buckets: capacity per level = #voxels at that level (each
    // voxel is queued at most once, always under its own key).  No
    // separate 'queued' flag: a voxel is queued iff its label is set.
    std::vector<int64_t> start(n_levels + 1, 0);
    for (int64_t i = 0; i < n; i++) start[key[i] + 1]++;
    for (int64_t l = 0; l < n_levels; l++) start[l + 1] += start[l];
    std::vector<int64_t> slot(n);       // bucket storage (voxel indices)
    std::vector<int64_t> wcur(start.begin(), start.end() - 1);
    std::vector<int64_t> rcur(start.begin(), start.end() - 1);

    int64_t cur = n_levels;
    for (int64_t i = 0; i < n; i++) {
        if (labels[i] != 0 && (!mask || mask[i])) {
            slot[wcur[key[i]]++] = i;
            if ((int64_t)key[i] < cur) cur = key[i];
        }
    }
    while (cur < n_levels) {
        if (rcur[cur] == wcur[cur]) {
            cur++;
            continue;
        }
        const int64_t idx = slot[rcur[cur]++];
        const uint64_t lab = labels[idx];
        const int64_t z = idx / strides[0];
        const int64_t y = (idx % strides[0]) / X;
        const int64_t x = idx % X;
        const int64_t pos[3] = {z, y, x};
        for (int d = 0; d < 3; d++) {
            for (int s = -1; s <= 1; s += 2) {
                if (pos[d] + s < 0 || pos[d] + s >= lims[d]) continue;
                const int64_t j = idx + s * strides[d];
                if (labels[j] != 0) continue;
                if (mask && !mask[j]) continue;
                labels[j] = lab;
                const int64_t lv = key[j];
                slot[wcur[lv]++] = j;
                if (lv < cur) cur = lv;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// mutex watershed (mwatershed capability)
// ---------------------------------------------------------------------------

// Edges are processed by descending |weight|; weight > 0 is attractive
// (merge unless a mutex exists between the clusters), weight < 0 is
// repulsive (install a mutex unless already merged).
//
// Mutex constraints are stored LAZILY: each cluster root keeps a vector
// of *node ids* on the far side of its repulsive edges. A constraint
// check resolves the smaller cluster's stored nodes through the
// union-find (path compression keeps this cheap) and compares against
// the other root. Merging splices the smaller vector into the larger
// (small-to-large: O(total log n) moves) with no back-pointer
// maintenance — the rewrite of the earlier hash-set design that
// rehashed per repulsive edge and was ~50x slower at tens of millions
// of edges.
void mutex_watershed(
    uint64_t n_nodes,
    const uint64_t* eu,
    const uint64_t* ev,
    const double* weights,   // signed
    const uint64_t* order,   // edge indices sorted by |weight| desc
    uint64_t n_edges,
    uint64_t* out_labels) {
    UnionFind uf(n_nodes);
    std::vector<std::vector<uint64_t>> mutex_nodes(n_nodes);

    auto have_mutex = [&](uint64_t ra, uint64_t rb) {
        auto& la = mutex_nodes[ra];
        auto& lb = mutex_nodes[rb];
        bool a_small = la.size() <= lb.size();
        auto& small = a_small ? la : lb;
        uint64_t other = a_small ? rb : ra;
        for (uint64_t& node : small) {
            uint64_t r = uf.find(node);
            node = r;  // path-compress the stored entry in place: a
                       // root stands for the same constraint and keeps
                       // later finds O(1)
            if (r == other) return true;
        }
        return false;
    };

    for (uint64_t k = 0; k < n_edges; k++) {
        uint64_t e = order[k];
        uint64_t ra = uf.find(eu[e]);
        uint64_t rb = uf.find(ev[e]);
        if (ra == rb) continue;
        double w = weights[e];
        if (w > 0) {
            if (have_mutex(ra, rb)) continue;
            // splice the smaller mutex list into the larger, keep the
            // list on the surviving root
            uint64_t big = ra, small = rb;
            if (mutex_nodes[big].size() < mutex_nodes[small].size())
                std::swap(big, small);
            uf.merge_into(big, small);
            auto& lb_ = mutex_nodes[big];
            auto& ls_ = mutex_nodes[small];
            lb_.insert(lb_.end(), ls_.begin(), ls_.end());
            ls_.clear();
            ls_.shrink_to_fit();
        } else {
            // store far-side *nodes*; roots may change later
            mutex_nodes[ra].push_back(ev[e]);
            mutex_nodes[rb].push_back(eu[e]);
        }
    }
    for (uint64_t i = 0; i < n_nodes; i++) out_labels[i] = uf.find(i);
}

// ---------------------------------------------------------------------------
// hierarchical region-graph agglomeration (waterz capability)
// ---------------------------------------------------------------------------

// Scoring: score(edge) = 1 - stat(affinities on the boundary), where
// stat is the mean (merge_function "mean") or a histogram quantile over
// 256 bins ("hist_quant_<q>[_initmax]"). Merges proceed in ascending
// score order up to `threshold`; each merge is recorded. The final
// scores of the *initial* RAG edges (score at which their endpoints
// merged) are written back for LUT-stage thresholding — the analogue of
// waterz merge history + MergeTree.find_merge (reference
// bootstrapper/post/blockwise/hglom/agglom.py:108-152).

struct EdgeAcc {
    double sum = 0;
    uint64_t count = 0;
    uint32_t hist[256] = {0};
};

struct MergeEvent {
    uint64_t a, b, c;
    double score;
};

static double edge_score(const EdgeAcc& acc, int mode, int quantile,
                         bool init_max) {
    if (acc.count == 0) return 1.0;
    if (mode == 0) return 1.0 - acc.sum / (double)acc.count;
    // histogram quantile
    uint64_t target = (uint64_t)((quantile / 100.0) * (double)(acc.count - 1));
    uint64_t seen = 0;
    for (int b = 0; b < 256; b++) {
        seen += acc.hist[b];
        if (seen > target) return 1.0 - (b + 0.5) / 256.0;
    }
    return 1.0 - acc.sum / (double)acc.count;
    (void)init_max;
}

// fragments: (Z,Y,X) uint64 (0 = background), affs: (3, Z, Y, X) float32
// (z, y, x direct-neighbour affinities, aff[c][v] links v and v+step_c).
// Outputs: merge history arrays (a, b, score) of length <= max_merges
// (returned count), plus per-initial-edge u, v, merged-score triples.
// Caller passes pre-allocated buffers sized by *_capacity; the function
// returns the number written (or -1 if capacity was too small).
int64_t agglomerate(
    const uint64_t* fragments,
    const float* affs,
    int64_t Z, int64_t Y, int64_t X,
    double threshold,
    int score_mode,        // 0 = mean, 1 = hist quantile
    int quantile,          // for score_mode 1
    int init_max,
    // outputs
    uint64_t* edge_u, uint64_t* edge_v, double* edge_score_out,
    int64_t edge_capacity,
    uint64_t* merge_a, uint64_t* merge_b, double* merge_score_out,
    int64_t merge_capacity,
    int64_t* n_merges_out) {
    const int64_t n = Z * Y * X;
    const int64_t strides[3] = {Y * X, X, 1};
    const int64_t lims[3] = {Z, Y, X};

    // dense relabel of fragment ids
    std::unordered_map<uint64_t, uint32_t> dense;
    std::vector<uint64_t> orig;
    auto densify = [&](uint64_t f) -> uint32_t {
        auto it = dense.find(f);
        if (it != dense.end()) return it->second;
        uint32_t d = (uint32_t)orig.size();
        dense[f] = d;
        orig.push_back(f);
        return d;
    };

    // accumulate boundary affinities per fragment pair
    std::unordered_map<uint64_t, EdgeAcc> accs;  // key = (a<<32)|b, a<b dense
    for (int64_t z = 0; z < Z; z++)
        for (int64_t y = 0; y < Y; y++)
            for (int64_t x = 0; x < X; x++) {
                int64_t i = z * strides[0] + y * strides[1] + x;
                uint64_t fa = fragments[i];
                if (fa == 0) continue;
                int64_t pos[3] = {z, y, x};
                for (int c = 0; c < 3; c++) {
                    if (pos[c] + 1 >= lims[c]) continue;
                    int64_t j = i + strides[c];
                    uint64_t fb = fragments[j];
                    if (fb == 0 || fb == fa) continue;
                    // affinity channel c at the *offset* voxel links
                    // j-step and j; use value at the farther voxel
                    float a = affs[c * n + j];
                    uint32_t da = densify(fa), db = densify(fb);
                    uint64_t key = da < db
                                       ? ((uint64_t)da << 32) | db
                                       : ((uint64_t)db << 32) | da;
                    EdgeAcc& acc = accs[key];
                    acc.sum += a;
                    acc.count++;
                    int bin = (int)(a * 255.0f);
                    if (bin < 0) bin = 0;
                    if (bin > 255) bin = 255;
                    acc.hist[bin]++;
                }
            }

    const uint64_t n_frags = orig.size();
    if ((int64_t)accs.size() > edge_capacity) return -1;

    UnionFind uf(n_frags);
    // adjacency: cluster root -> (neighbor root -> acc)
    std::vector<std::unordered_map<uint32_t, EdgeAcc>> adj(n_frags);
    for (auto& kv : accs) {
        uint32_t a = (uint32_t)(kv.first >> 32);
        uint32_t b = (uint32_t)(kv.first & 0xffffffffu);
        adj[a][b] = kv.second;
        adj[b][a] = kv.second;
    }

    struct QE {
        double score;
        uint64_t order;
        uint32_t a, b;
    };
    struct QCmp {
        bool operator()(const QE& x, const QE& y) const {
            if (x.score != y.score) return x.score > y.score;
            return x.order > y.order;
        }
    };
    std::priority_queue<QE, std::vector<QE>, QCmp> pq;
    uint64_t order = 0;
    for (auto& kv : accs) {
        uint32_t a = (uint32_t)(kv.first >> 32);
        uint32_t b = (uint32_t)(kv.first & 0xffffffffu);
        pq.push({edge_score(kv.second, score_mode, quantile, init_max),
                 order++, a, b});
    }

    // record initial edges for the RAG output (score filled at merge time
    // or left at the sentinel 2.0 = "never merged below threshold")
    int64_t n_edges = 0;
    std::vector<std::pair<uint32_t, uint32_t>> edges_d;
    edges_d.reserve(accs.size());
    // per-cluster-root incident initial-edge lists (small-to-large)
    std::vector<std::vector<int64_t>> incident(n_frags);
    for (auto& kv : accs) {
        uint32_t a = (uint32_t)(kv.first >> 32);
        uint32_t b = (uint32_t)(kv.first & 0xffffffffu);
        edge_u[n_edges] = orig[a];
        edge_v[n_edges] = orig[b];
        edge_score_out[n_edges] = 2.0;
        edges_d.push_back({a, b});
        incident[a].push_back(n_edges);
        incident[b].push_back(n_edges);
        n_edges++;
    }

    int64_t n_merges = 0;
    while (!pq.empty()) {
        QE e = pq.top();
        pq.pop();
        uint32_t ra = (uint32_t)uf.find(e.a);
        uint32_t rb = (uint32_t)uf.find(e.b);
        if (ra == rb) continue;
        // lazy validation: current score of the edge between ra and rb
        auto it = adj[ra].find(rb);
        if (it == adj[ra].end()) continue;
        double cur = edge_score(it->second, score_mode, quantile, init_max);
        if (cur > e.score + 1e-12) {
            pq.push({cur, order++, ra, rb});
            continue;
        }
        if (cur > threshold) break;

        if (n_merges >= merge_capacity) return -2;
        // merge rb into ra; ra = bigger adjacency (less rewiring)
        if (adj[ra].size() < adj[rb].size()) std::swap(ra, rb);
        uf.merge_into(ra, rb);
        merge_a[n_merges] = orig[ra];
        merge_b[n_merges] = orig[rb];
        merge_score_out[n_merges] = cur;

        // initial edges that just became intra-cluster get this score
        auto& inc_a = incident[ra];
        auto& inc_b = incident[rb];
        auto& small = inc_a.size() < inc_b.size() ? inc_a : inc_b;
        for (int64_t ei : small) {
            if (edge_score_out[ei] <= 1.0) continue;
            if (uf.find(edges_d[ei].first) == uf.find(edges_d[ei].second))
                edge_score_out[ei] = cur;
        }
        auto& big = inc_a.size() < inc_b.size() ? inc_b : inc_a;
        big.insert(big.end(), small.begin(), small.end());
        small.clear();
        if (&big != &inc_a) incident[ra] = std::move(incident[rb]);

        n_merges++;

        adj[ra].erase(rb);
        adj[rb].erase(ra);
        for (auto& nb : adj[rb]) {
            uint32_t c = nb.first;
            adj[c].erase(rb);
            EdgeAcc& merged = adj[ra][c];
            merged.sum += nb.second.sum;
            merged.count += nb.second.count;
            for (int b = 0; b < 256; b++) merged.hist[b] += nb.second.hist[b];
            adj[c][ra] = merged;
            pq.push({edge_score(merged, score_mode, quantile, init_max),
                     order++, ra, c});
        }
        adj[rb].clear();
    }

    *n_merges_out = n_merges;
    return n_edges;
}

// ---------------------------------------------------------------------------
// dense mutex watershed: edge generation + weight prep + radix sort +
// clustering + densified labels in ONE native pass
// ---------------------------------------------------------------------------

// The edge-list path (mutex_watershed above) needs the caller to build
// u/v/weight/order arrays; on slow hosts the numpy index math for that
// costs 10x the clustering itself. This variant takes the affinity grid
// directly: edges are generated channel-major in C voxel order (same
// order the python path produced), weights get per-channel bias plus
// optional counter-based gaussian noise, the sort is a stable LSD radix
// on the |weight| float bits, and labels come back densified to 1..K.
// Randomised stride subsampling and noise are deterministic in
// (seed, channel, voxel) via splitmix64, independent of loop order.

static inline uint64_t splitmix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ull;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
    return x ^ (x >> 31);
}

static inline double u01(uint64_t h) {
    // uniform in (0,1): top 53 bits, offset half a ulp so log() is safe
    return ((double)(h >> 11) + 0.5) * (1.0 / 9007199254740992.0);
}

uint64_t mutex_watershed_dense(
    const float* affs,            // C x n, grids C-order (Z,Y,X)
    int64_t Z, int64_t Y, int64_t X,
    const int32_t* neighborhood,  // C x 3 offsets
    uint64_t C,                   // < 128 (channel packs beside a sign bit)
    const double* bias,           // C
    const int32_t* strides,       // C x 3; (1,1,1) = keep every voxel
    const uint8_t* randomized,    // C; nonzero = random keep at 1/prod(stride)
    double noise_eps,             // 0 = no noise
    uint64_t seed,
    uint64_t* out_labels) {       // n; dense ids 1..K (K returned)
    const uint64_t n = (uint64_t)Z * Y * X;

    // --- 1. generate edges (channel-major, C voxel order) ---
    std::vector<uint32_t> eu;   // source voxel, flat
    std::vector<uint8_t> ec;    // channel | attractive << 7
    std::vector<uint32_t> key;  // float bits of |w| (monotonic for w >= 0)
    int64_t doff[128];
    {
        // deterministic = edges kept for sure (strided non-randomized
        // channels); randomized channels keep ~1/prod(stride) of their
        // edges, so reserve the EXPECTED count (+4 sd binomial slack),
        // not the full grid — full-grid reservation over-allocates
        // ~prod(stride)x (e.g. 10 GB of 99%-unused vectors on a
        // CREMI-scale volume with (1,10,10)-strided long-range offsets)
        uint64_t deterministic = 0;
        double expected = 0.0;
        for (uint64_t c = 0; c < C; c++) {
            const int32_t* o = neighborhood + 3 * c;
            uint64_t vz = (uint64_t)std::max<int64_t>(0, Z - std::abs(o[0]));
            uint64_t vy = (uint64_t)std::max<int64_t>(0, Y - std::abs(o[1]));
            uint64_t vx = (uint64_t)std::max<int64_t>(0, X - std::abs(o[2]));
            const int32_t* s = strides + 3 * c;
            const double full = (double)vz * vy * vx;
            if (!randomized[c]) {
                vz = (vz + s[0] - 1) / s[0];
                vy = (vy + s[1] - 1) / s[1];
                vx = (vx + s[2] - 1) / s[2];
                deterministic += vz * vy * vx;
            } else {
                const double keep_p =
                    1.0 / ((double)s[0] * s[1] * s[2]);
                const double mean = full * keep_p;
                expected += mean + 4.0 * std::sqrt(mean) + 1024.0;
            }
        }
        // the sort packs the edge index into the low 32 bits: the
        // deterministic population alone overflowing is certain failure
        if (deterministic >= (1ull << 32)) return UINT64_MAX;
        const uint64_t cap = deterministic + (uint64_t)expected;
        eu.reserve(cap); ec.reserve(cap); key.reserve(cap);
    }
    for (uint64_t c = 0; c < C; c++) {
        const int32_t oz = neighborhood[3 * c], oy = neighborhood[3 * c + 1],
                      ox = neighborhood[3 * c + 2];
        const int64_t z0 = std::max<int64_t>(0, -oz), z1 = std::min<int64_t>(Z, Z - oz);
        const int64_t y0 = std::max<int64_t>(0, -oy), y1 = std::min<int64_t>(Y, Y - oy);
        const int64_t x0 = std::max<int64_t>(0, -ox), x1 = std::min<int64_t>(X, X - ox);
        const int32_t sz = randomized[c] ? 1 : strides[3 * c];
        const int32_t sy = randomized[c] ? 1 : strides[3 * c + 1];
        const int32_t sx = randomized[c] ? 1 : strides[3 * c + 2];
        const bool rnd = randomized[c] != 0;
        const double keep_p = 1.0 / ((double)strides[3 * c] *
                                     strides[3 * c + 1] * strides[3 * c + 2]);
        const bool noisy = noise_eps != 0.0;
        const float b = (float)bias[c];
        const float* ac = affs + c * n;
        const uint64_t cbase = c * n;
        doff[c] = (int64_t)oz * Y * X + (int64_t)oy * X + ox;
        for (int64_t z = z0; z < z1; z += sz)
            for (int64_t y = y0; y < y1; y += sy) {
                uint64_t row = ((uint64_t)z * Y + y) * X;
                for (int64_t x = x0; x < x1; x += sx) {
                    const uint64_t u = row + x;
                    uint64_t h = 0;
                    if (rnd || noisy) h = splitmix64(seed ^ splitmix64(cbase + u));
                    if (rnd && u01(h) >= keep_p) continue;
                    float w = ac[u] + b;
                    if (noisy) {
                        const uint64_t h1 = splitmix64(h);
                        const uint64_t h2 = splitmix64(h1);
                        w += (float)(noise_eps *
                                     std::sqrt(-2.0 * std::log(u01(h1))) *
                                     std::cos(6.283185307179586 * u01(h2)));
                    }
                    uint32_t kb;
                    const float aw = std::fabs(w);
                    std::memcpy(&kb, &aw, 4);
                    eu.push_back((uint32_t)u);
                    ec.push_back((uint8_t)(c | (w > 0.f ? 0x80u : 0u)));
                    key.push_back(kb);
                }
            }
    }
    const uint64_t E = eu.size();
    // exact guard: (~key << 32 | i) truncates indices >= 2^32, bleeding
    // high index bits into the sort key and retrieving wrapped edge ids
    // — a silently wrong clustering rather than an error
    if (E >= (1ull << 32)) return UINT64_MAX;

    // --- 2. stable LSD radix sort, descending |w| (ascending ~key) ---
    // packed (~key << 32 | edge index); 4 byte passes over the key half
    std::vector<uint64_t> a(E), b(E);
    for (uint64_t i = 0; i < E; i++)
        a[i] = ((uint64_t)(~key[i]) << 32) | i;
    key.clear(); key.shrink_to_fit();
    for (int pass = 4; pass < 8; pass++) {
        uint64_t count[257] = {0};
        const int shift = pass * 8;
        for (uint64_t i = 0; i < E; i++)
            count[((a[i] >> shift) & 0xFF) + 1]++;
        for (int j = 0; j < 256; j++) count[j + 1] += count[j];
        for (uint64_t i = 0; i < E; i++)
            b[count[(a[i] >> shift) & 0xFF]++] = a[i];
        std::swap(a, b);
    }
    b.clear(); b.shrink_to_fit();

    // --- 3. mutex clustering (same rule as mutex_watershed above) ---
    UnionFind uf(n);
    std::vector<std::vector<uint64_t>> mutex_nodes(n);
    auto have_mutex = [&](uint64_t ra, uint64_t rb) {
        auto& la = mutex_nodes[ra];
        auto& lb = mutex_nodes[rb];
        bool a_small = la.size() <= lb.size();
        auto& small = a_small ? la : lb;
        uint64_t other = a_small ? rb : ra;
        for (uint64_t& node : small) {
            uint64_t r = uf.find(node);
            node = r;
            if (r == other) return true;
        }
        return false;
    };
    for (uint64_t k = 0; k < E; k++) {
        const uint32_t e = (uint32_t)a[k];
        const uint64_t u = eu[e];
        const uint64_t v = (uint64_t)((int64_t)u + doff[ec[e] & 0x7F]);
        uint64_t ra = uf.find(u);
        uint64_t rb = uf.find(v);
        if (ra == rb) continue;
        if (ec[e] & 0x80) {
            if (have_mutex(ra, rb)) continue;
            uint64_t big = ra, small = rb;
            if (mutex_nodes[big].size() < mutex_nodes[small].size())
                std::swap(big, small);
            uf.merge_into(big, small);
            auto& lb_ = mutex_nodes[big];
            auto& ls_ = mutex_nodes[small];
            lb_.insert(lb_.end(), ls_.begin(), ls_.end());
            ls_.clear();
            ls_.shrink_to_fit();
        } else {
            mutex_nodes[ra].push_back(v);
            mutex_nodes[rb].push_back(u);
        }
    }

    // --- 4. densify roots to 1..K (root-index order == np.unique order) ---
    uint64_t K = 0;
    for (uint64_t i = 0; i < n; i++)
        if (uf.find(i) == i) out_labels[i] = ++K;
    for (uint64_t i = 0; i < n; i++) {
        const uint64_t r = uf.find(i);
        if (r != i) out_labels[i] = out_labels[r];
    }
    return K;
}

// ---------------------------------------------------------------------------
// sparse (gt, seg) contingency table (funlib.evaluate rand_voi capability)
// ---------------------------------------------------------------------------

// One pass over the paired label volumes, hashing each label to a
// dense index on first sight and counting (gt, seg) co-occurrences.
// Replaces three full np.unique sorts of the volume (O(n log n) with
// big constants) with O(n) hashing — the reference outsources this
// exact hot loop to funlib.evaluate's C++ for the same reason.
//
// Two-call protocol (ctypes-friendly, output sizes unknown upfront):
// build returns an opaque handle + counts, fetch copies the arrays out
// and frees the handle.
struct Contingency {
    std::vector<uint64_t> gt_ids, seg_ids;      // first-seen order
    std::vector<uint32_t> pair_gi, pair_sj;     // dense pair indices
    std::vector<uint64_t> pair_counts;
    uint64_t kept = 0;
};

void* contingency_build(
    const uint64_t* gt, const uint64_t* seg, uint64_t n,
    int ignore_gt_zero,
    uint64_t* out_n_pairs, uint64_t* out_n_gt, uint64_t* out_n_seg,
    uint64_t* out_kept) {
    auto* c = new Contingency();
    std::unordered_map<uint64_t, uint32_t> gmap, smap;
    std::unordered_map<uint64_t, uint64_t> pmap;  // (gi<<32)|sj -> slot
    gmap.reserve(1024);
    smap.reserve(1024);
    pmap.reserve(4096);
    // run-length fast path: label volumes are spatially coherent, so
    // consecutive voxels usually repeat the same (gt, seg) pair — count
    // the run directly and hash only at pair boundaries
    uint64_t prev_g = ~(uint64_t)0, prev_s = ~(uint64_t)0;
    uint64_t prev_slot = 0;
    uint32_t prev_gi = 0;
    bool have_prev = false;
    for (uint64_t i = 0; i < n; i++) {
        const uint64_t g = gt[i];
        if (ignore_gt_zero && g == 0) continue;
        const uint64_t s = seg[i];
        if (have_prev && g == prev_g && s == prev_s) {
            c->pair_counts[prev_slot]++;
            c->kept++;
            continue;
        }
        uint32_t gi;
        if (have_prev && g == prev_g) {
            gi = prev_gi;
        } else {
            auto gi_it = gmap.emplace(g, (uint32_t)c->gt_ids.size());
            if (gi_it.second) c->gt_ids.push_back(g);
            gi = gi_it.first->second;
        }
        auto sj_it = smap.emplace(s, (uint32_t)c->seg_ids.size());
        if (sj_it.second) c->seg_ids.push_back(s);
        const uint32_t sj = sj_it.first->second;
        const uint64_t key = ((uint64_t)gi << 32) | sj;
        auto p_it = pmap.emplace(key, c->pair_counts.size());
        if (p_it.second) {
            c->pair_gi.push_back(gi);
            c->pair_sj.push_back(sj);
            c->pair_counts.push_back(1);
        }
        prev_slot = p_it.first->second;
        if (!p_it.second) c->pair_counts[prev_slot]++;
        prev_g = g;
        prev_s = s;
        prev_gi = gi;
        have_prev = true;
        c->kept++;
    }
    *out_n_pairs = c->pair_counts.size();
    *out_n_gt = c->gt_ids.size();
    *out_n_seg = c->seg_ids.size();
    *out_kept = c->kept;
    return c;
}

void contingency_fetch(
    void* handle,
    uint64_t* gt_ids, uint64_t* seg_ids,
    uint32_t* pair_gi, uint32_t* pair_sj, uint64_t* pair_counts) {
    auto* c = (Contingency*)handle;
    std::memcpy(gt_ids, c->gt_ids.data(),
                c->gt_ids.size() * sizeof(uint64_t));
    std::memcpy(seg_ids, c->seg_ids.data(),
                c->seg_ids.size() * sizeof(uint64_t));
    std::memcpy(pair_gi, c->pair_gi.data(),
                c->pair_gi.size() * sizeof(uint32_t));
    std::memcpy(pair_sj, c->pair_sj.data(),
                c->pair_sj.size() * sizeof(uint32_t));
    std::memcpy(pair_counts, c->pair_counts.data(),
                c->pair_counts.size() * sizeof(uint64_t));
    delete c;
}

// Apply a LUT (old ids -> new ids) to a uint64 array. LUT given as two
// sorted-by-old arrays; ids not present map to themselves.
void replace_values(
    const uint64_t* in, uint64_t n,
    const uint64_t* lut_old, const uint64_t* lut_new, uint64_t lut_n,
    uint64_t* out) {
    for (uint64_t i = 0; i < n; i++) {
        const uint64_t* lo = std::lower_bound(lut_old, lut_old + lut_n, in[i]);
        if (lo != lut_old + lut_n && *lo == in[i]) {
            out[i] = lut_new[lo - lut_old];
        } else {
            out[i] = in[i];
        }
    }
}

// ---------------------------------------------------------------------------
// recursive min-cut seed separation (eval/mincut.py split_graph core)
// ---------------------------------------------------------------------------
//
// Replaces the networkx preflow-push path (measured 90% of a
// skeleton-dense threshold sweep): separate seed-node sets by
// repeated s-t min-cuts with Dinic's algorithm, funlib split_graph
// semantics (one split counted per cut; final connected components
// labeled into out_labels).

namespace {

struct Dinic {
    struct E { uint32_t to; double cap; uint32_t rev; };
    std::vector<std::vector<E>> g;
    std::vector<int32_t> level, it;

    explicit Dinic(uint32_t n) : g(n), level(n), it(n) {}

    void add_edge(uint32_t a, uint32_t b, double cap, bool undirected) {
        g[a].push_back({b, cap, (uint32_t)g[b].size()});
        g[b].push_back({a, undirected ? cap : 0.0,
                        (uint32_t)(g[a].size() - 1)});
    }
    bool bfs(uint32_t s, uint32_t t) {
        std::fill(level.begin(), level.end(), -1);
        std::queue<uint32_t> q;
        level[s] = 0;
        q.push(s);
        while (!q.empty()) {
            uint32_t v = q.front(); q.pop();
            for (const E& e : g[v])
                if (e.cap > 1e-12 && level[e.to] < 0) {
                    level[e.to] = level[v] + 1;
                    q.push(e.to);
                }
        }
        return level[t] >= 0;
    }
    double dfs(uint32_t v, uint32_t t, double f) {
        if (v == t) return f;
        for (int32_t& i = it[v]; i < (int32_t)g[v].size(); i++) {
            E& e = g[v][i];
            if (e.cap > 1e-12 && level[v] < level[e.to]) {
                double d = dfs(e.to, t, std::min(f, e.cap));
                if (d > 0) {
                    e.cap -= d;
                    g[e.to][e.rev].cap += d;
                    return d;
                }
            }
        }
        return 0;
    }
    void max_flow(uint32_t s, uint32_t t) {
        while (bfs(s, t)) {
            std::fill(it.begin(), it.end(), 0);
            while (dfs(s, t, 1e300) > 0) {}
        }
    }
    // source side of the cut: residual-reachable from s
    void source_side(uint32_t s, std::vector<uint8_t>& side) {
        std::fill(side.begin(), side.end(), 0);
        std::queue<uint32_t> q;
        side[s] = 1;
        q.push(s);
        while (!q.empty()) {
            uint32_t v = q.front(); q.pop();
            for (const E& e : g[v])
                if (e.cap > 1e-12 && !side[e.to]) {
                    side[e.to] = 1;
                    q.push(e.to);
                }
        }
    }
};

}  // namespace

int64_t split_graph_mincut(
    uint64_t n_nodes, uint64_t n_edges,
    const uint64_t* eu, const uint64_t* ev, const double* cap,
    uint64_t n_comps,
    const uint64_t* comp_offsets, const uint64_t* comp_nodes,
    uint64_t* out_labels) {
    std::vector<uint8_t> alive(n_edges, 1);
    // comp membership per node (UINT32_MAX none; nodes in several comps
    // keep the first — callers pre-remove shared/unsplittable nodes)
    std::vector<uint32_t> comp_of(n_nodes, UINT32_MAX);
    for (uint64_t c = 0; c < n_comps; c++)
        for (uint64_t i = comp_offsets[c]; i < comp_offsets[c + 1]; i++)
            if (comp_nodes[i] < n_nodes &&
                comp_of[comp_nodes[i]] == UINT32_MAX)
                comp_of[comp_nodes[i]] = (uint32_t)c;

    int64_t num_splits = 0;
    std::vector<uint64_t> part(n_nodes);
    while (true) {
        // connected components over alive edges
        UnionFind uf(n_nodes);
        for (uint64_t e = 0; e < n_edges; e++)
            if (alive[e]) uf.merge(eu[e], ev[e]);
        for (uint64_t i = 0; i < n_nodes; i++) part[i] = uf.find(i);

        // first part (by smallest root) holding >= 2 seed comps, and
        // its two lowest comp ids
        std::unordered_map<uint64_t, std::pair<uint32_t, uint32_t>> seen;
        uint64_t target = UINT64_MAX;
        for (uint64_t i = 0; i < n_nodes; i++) {
            uint32_t c = comp_of[i];
            if (c == UINT32_MAX) continue;
            auto r = seen.emplace(part[i],
                                  std::make_pair(c, UINT32_MAX));
            if (!r.second) {
                auto& pr = r.first->second;
                if (c != pr.first) {
                    if (c < pr.first) { pr.second = std::min(pr.second, pr.first); pr.first = c; }
                    else pr.second = std::min(pr.second, c);
                }
            }
        }
        for (auto& kv : seen)
            if (kv.second.second != UINT32_MAX &&
                (target == UINT64_MAX || kv.first < target))
                target = kv.first;
        if (target == UINT64_MAX) break;
        uint32_t ca = seen[target].first, cb = seen[target].second;

        // dense index for the target part's nodes
        std::unordered_map<uint64_t, uint32_t> idx;
        for (uint64_t i = 0; i < n_nodes; i++)
            if (part[i] == target)
                idx.emplace(i, (uint32_t)idx.size());
        uint32_t n_sub = (uint32_t)idx.size();
        Dinic din(n_sub + 2);
        uint32_t S = n_sub, T = n_sub + 1;
        std::vector<uint64_t> sub_edges;  // original edge indices
        for (uint64_t e = 0; e < n_edges; e++)
            if (alive[e] && part[eu[e]] == target) {
                din.add_edge(idx[eu[e]], idx[ev[e]],
                             std::max(cap[e], 1e-9), true);
                sub_edges.push_back(e);
            }
        for (uint64_t i = 0; i < n_nodes; i++) {
            if (part[i] != target || comp_of[i] == UINT32_MAX) continue;
            if (comp_of[i] == ca) din.add_edge(S, idx[i], 1e300, false);
            else if (comp_of[i] == cb) din.add_edge(idx[i], T, 1e300, false);
        }
        din.max_flow(S, T);
        std::vector<uint8_t> side(n_sub + 2, 0);
        din.source_side(S, side);
        bool any = false;
        for (uint64_t e : sub_edges)
            if (side[idx[eu[e]]] != side[idx[ev[e]]]) {
                alive[e] = 0;
                any = true;
            }
        if (!any) break;  // inseparable (infinite cut)
        num_splits++;
    }

    UnionFind uf(n_nodes);
    for (uint64_t e = 0; e < n_edges; e++)
        if (alive[e]) uf.merge(eu[e], ev[e]);
    std::unordered_map<uint64_t, uint64_t> relabel;
    for (uint64_t i = 0; i < n_nodes; i++) {
        uint64_t r = uf.find(i);
        auto it2 = relabel.emplace(r, (uint64_t)relabel.size());
        out_labels[i] = it2.first->second;
    }
    return num_splits;
}

}  // extern "C"
