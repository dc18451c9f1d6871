// Native host-side kernels for the generation pipeline.
//
// Per-molecule bond perception is O(n^2) table lookups and sanitization is
// O(E) valence accounting; in pure Python these loops take the host's
// time once the card samples fast. This library provides C
// implementations consumed via ctypes
// (`phoregen_tpu_torch/native/__init__.py`), mirroring the Python
// reference implementations exactly:
//   - EDM distance-based bond-order perception
//     (phoregen_tpu_torch/sample/predict_bonds.py)
//   - valence-table sanitization with aromatic + N+ slack
//     (phoregen_tpu_torch/sample/chem.py::sanitize_simple)
//   - connectivity via union-find (chem.py::_connected)
//
// A copy of phoregen_tpu/native/phoregen_host.cpp, the JAX package's
// source, with the same C interface. Build (done lazily by the Python
// loader into phoregen_tpu_torch/_build/; no external dependencies):
// g++ -O3 -shared -fPIC phoregen_host.cpp -o libphoregen_host_<hash>.so

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Bond tables are dense [n_z * n_z] arrays of max bond lengths in pm
// (0 = no entry), provided by Python from the symbol-keyed dicts so the
// chemistry data lives in exactly one place.
struct BondTables {
    const float* bonds1;   // [n_z * n_z]
    const float* bonds2;
    const float* bonds3;
    int n_z;               // table dimension (max atomic number + 1)
    float margin1, margin2, margin3;
};

static inline int bond_order(const BondTables* t, int z1, int z2, float d_pm) {
    const int i = z1 * t->n_z + z2;
    const float b1 = t->bonds1[i];
    if (b1 <= 0.0f || d_pm >= b1 + t->margin1) return 0;
    const float b2 = t->bonds2[i];
    if (b2 > 0.0f && d_pm < b2 + t->margin2) {
        const float b3 = t->bonds3[i];
        if (b3 > 0.0f && d_pm < b3 + t->margin3) return 3;
        return 2;
    }
    return 1;
}

// Predict undirected bonds for one molecule.
// elements: [n] atomic numbers; pos: [n*3] angstrom.
// out_i/out_j/out_order: caller-allocated, capacity max_bonds.
// Returns the number of bonds written (or -1 if capacity exceeded).
int predict_bonds(const BondTables* tables, int n, const int32_t* elements,
                  const float* pos, int32_t* out_i, int32_t* out_j,
                  int32_t* out_order, int max_bonds) {
    int m = 0;
    for (int i = 0; i < n; ++i) {
        const float xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
        for (int j = i + 1; j < n; ++j) {
            const float dx = xi - pos[3 * j];
            const float dy = yi - pos[3 * j + 1];
            const float dz = zi - pos[3 * j + 2];
            const float d_pm =
                100.0f * std::sqrt(dx * dx + dy * dy + dz * dz);
            const int order =
                bond_order(tables, elements[i], elements[j], d_pm);
            if (order > 0) {
                if (m >= max_bonds) return -1;
                out_i[m] = i;
                out_j[m] = j;
                out_order[m] = order;
                ++m;
            }
        }
    }
    return m;
}

// Valence-table sanitize + connectivity for one molecule.
// max_valence: [n_z] maximum allowed total valence per atomic number
//              (0 = unknown element -> fail).
// bonds: m undirected bonds (bi, bj, border with 4 = aromatic).
// Returns bit0 = sanitizable, bit1 = connected.
int check_mol(int n, const int32_t* elements, int m, const int32_t* bi,
              const int32_t* bj, const int32_t* border,
              const float* max_valence, int n_z) {
    if (n <= 0 || n > 4096 || m < 0) return 0;
    float order_sum[4096];
    int32_t arom_deg[4096];
    int32_t parent[4096];
    std::memset(order_sum, 0, sizeof(float) * n);
    std::memset(arom_deg, 0, sizeof(int32_t) * n);
    for (int i = 0; i < n; ++i) parent[i] = i;

    // union-find with path halving
    auto find = [&](int a) {
        while (parent[a] != a) {
            parent[a] = parent[parent[a]];
            a = parent[a];
        }
        return a;
    };

    for (int e = 0; e < m; ++e) {
        const int i = bi[e], j = bj[e], t = border[e];
        if (i < 0 || j < 0 || i >= n || j >= n) return 0;
        const float o = (t == 4) ? 1.5f : (float)t;
        order_sum[i] += o;
        order_sum[j] += o;
        if (t == 4) {
            ++arom_deg[i];
            ++arom_deg[j];
        }
        const int ri = find(i), rj = find(j);
        if (ri != rj) parent[ri] = rj;
    }

    int ok = 1;
    for (int i = 0; i < n && ok; ++i) {
        const int z = elements[i];
        if (z < 0 || z >= n_z || max_valence[z] <= 0.0f) { ok = 0; break; }
        float slack = (arom_deg[i] > 0) ? 0.5f : 0.0f;
        if (z == 7) slack += 1.0f;  // N+ repair parity (chem.py)
        if (order_sum[i] > max_valence[z] + slack + 1e-6f) ok = 0;
        if (arom_deg[i] == 1) ok = 0;  // dangling aromatic bond
    }

    int connected = 1;
    if (n > 1) {
        const int root = find(0);
        for (int i = 1; i < n; ++i)
            if (find(i) != root) { connected = 0; break; }
    }
    return (ok ? 1 : 0) | (connected ? 2 : 0);
}

// Batch entry: decode a padded sampling batch on the host in one call.
// For each of B molecules: drop mask-class/padded atoms, predict bonds (EDM),
// sanitize + connectivity. Inputs are the argmax'd grids:
//   atom_type: [B*NL] (class id; >= n_real_classes or !mask -> dropped)
//   pos:       [B*NL*3]
//   lig_mask:  [B*NL] (0/1)
//   class_to_z:[n_classes] atomic number per class id (-1 = drop)
// Outputs (caller-allocated):
//   out_n:     [B] kept-atom counts
//   out_flags: [B] bit0 sanitizable, bit1 connected (EDM bonds)
int decode_batch_edm(const BondTables* tables, const float* max_valence,
                     int n_z, int B, int NL, const int32_t* atom_type,
                     const float* pos, const uint8_t* lig_mask,
                     const int32_t* class_to_z, int n_classes,
                     int32_t* out_n, int32_t* out_flags) {
    const int max_bonds = NL * NL;
    int32_t* bi = new int32_t[max_bonds];
    int32_t* bj = new int32_t[max_bonds];
    int32_t* bo = new int32_t[max_bonds];
    int32_t* elems = new int32_t[NL];
    float* p = new float[NL * 3];
    for (int b = 0; b < B; ++b) {
        int n = 0;
        for (int a = 0; a < NL; ++a) {
            const int idx = b * NL + a;
            if (!lig_mask[idx]) continue;
            const int cls = atom_type[idx];
            if (cls < 0 || cls >= n_classes) continue;
            const int z = class_to_z[cls];
            if (z < 0) continue;
            elems[n] = z;
            p[3 * n] = pos[3 * idx];
            p[3 * n + 1] = pos[3 * idx + 1];
            p[3 * n + 2] = pos[3 * idx + 2];
            ++n;
        }
        out_n[b] = n;
        const int m = predict_bonds(tables, n, elems, p, bi, bj, bo,
                                    max_bonds);
        out_flags[b] = (m < 0) ? 0
            : check_mol(n, elems, m, bi, bj, bo, max_valence, n_z);
    }
    delete[] bi; delete[] bj; delete[] bo; delete[] elems; delete[] p;
    return 0;
}

}  // extern "C"
