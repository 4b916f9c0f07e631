// Native Pauli-term generation for fermion-to-qubit mappings (JW / BK).
//
// Mirrors the bitmask formulation of nbed_tpu/ham/qubit.py
// (_map_interaction_operator): each ladder operator a_p / a_p^dagger is a
// sum of two Pauli strings encoded as (x, z) int64 bitmasks with a
// mode-independent complex scalar; a one-body term a_p^dag a_q expands into
// 4 strings, a two-body term a_p^dag a_q^dag a_r a_s into 16. Phase
// bookkeeping: multiplying string B onto accumulator A flips the sign by
// parity(z_A & x_B); the per-operator scalars multiply once per combo.
//
// The reference delegates this to OpenFermion's jordan_wigner (SURVEY
// section 2.3); this engine replaces the numpy sort/segment-sum pipeline
// with a single-pass generate -> sort -> reduce in C++ for large
// registers (term generation throughput is a BASELINE.md metric).
//
// ABI: plain C, double/int64 arrays, caller allocates worst-case outputs
// (4*n1 + 16*n2 rows). Returns the number of unique surviving terms.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Row {
    uint64_t x, z;
    double re, im;
};

inline int parity64(uint64_t v) { return __builtin_popcountll(v) & 1; }

// expand one fermionic term (product of n_f ladder ops) into 2^n_f rows
inline void expand_term(
    int n_f, const int* modes, const int* flavors,  // flavor 1=dagger
    const int64_t* dx, const int64_t* dz, const int64_t* ax, const int64_t* az,
    int n_modes,
    const double* dsc, const double* asc,  // (2,2): [k][re,im]
    double cre, double cim, std::vector<Row>& out)
{
    const int n_combo = 1 << n_f;
    for (int combo = 0; combo < n_combo; ++combo) {
        uint64_t x_acc = 0, z_acc = 0;
        int par = 0;
        double sre = 1.0, sim = 0.0;
        for (int f = 0; f < n_f; ++f) {
            const int k = (combo >> f) & 1;
            const int m = modes[f];
            const int64_t* tx = flavors[f] ? dx : ax;
            const int64_t* tz = flavors[f] ? dz : az;
            const double* sc = flavors[f] ? dsc : asc;
            const uint64_t bx = (uint64_t)tx[k * n_modes + m];
            const uint64_t bz = (uint64_t)tz[k * n_modes + m];
            par ^= parity64(z_acc & bx);
            const double kre = sc[2 * k], kim = sc[2 * k + 1];
            const double nre = sre * kre - sim * kim;
            sim = sre * kim + sim * kre;
            sre = nre;
            x_acc ^= bx;
            z_acc ^= bz;
        }
        double re = cre * sre - cim * sim;
        double im = cre * sim + cim * sre;
        if (par) { re = -re; im = -im; }
        out.push_back(Row{x_acc, z_acc, re, im});
    }
}

}  // namespace

extern "C" int64_t nbed_map_terms(
    int n_modes,
    const int64_t* dx, const int64_t* dz,   // (2, n) dagger x/z masks
    const int64_t* ax, const int64_t* az,   // (2, n) annihilation masks
    const double* dsc, const double* asc,   // (2, 2) scalars re/im per k
    int64_t n1, const int32_t* pq1, const double* c1,       // (n1,2), (n1,2) re/im
    int64_t n2, const int32_t* pqrs2, const double* c2,     // (n2,4), (n2,2)
    double tol,
    int64_t* out_x, int64_t* out_z, double* out_c)          // (cap,), (cap,), (cap,2)
{
    std::vector<Row> rows;
    rows.reserve((size_t)(4 * n1 + 16 * n2));

    {
        int modes[2], flavors[2] = {1, 0};
        for (int64_t t = 0; t < n1; ++t) {
            modes[0] = pq1[2 * t];
            modes[1] = pq1[2 * t + 1];
            expand_term(2, modes, flavors, dx, dz, ax, az, n_modes,
                        dsc, asc, c1[2 * t], c1[2 * t + 1], rows);
        }
    }
    {
        int modes[4], flavors[4] = {1, 1, 0, 0};
        for (int64_t t = 0; t < n2; ++t) {
            for (int j = 0; j < 4; ++j) modes[j] = pqrs2[4 * t + j];
            expand_term(4, modes, flavors, dx, dz, ax, az, n_modes,
                        dsc, asc, c2[2 * t], c2[2 * t + 1], rows);
        }
    }

    std::sort(rows.begin(), rows.end(), [](const Row& a, const Row& b) {
        return a.x != b.x ? a.x < b.x : a.z < b.z;
    });

    int64_t n_out = 0;
    size_t i = 0;
    const size_t n = rows.size();
    while (i < n) {
        const uint64_t x = rows[i].x, z = rows[i].z;
        double re = 0.0, im = 0.0;
        while (i < n && rows[i].x == x && rows[i].z == z) {
            re += rows[i].re;
            im += rows[i].im;
            ++i;
        }
        if (std::sqrt(re * re + im * im) > tol) {
            out_x[n_out] = (int64_t)x;
            out_z[n_out] = (int64_t)z;
            out_c[2 * n_out] = re;
            out_c[2 * n_out + 1] = im;
            ++n_out;
        }
    }
    return n_out;
}
