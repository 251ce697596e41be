// qbx_native — C++17 host-side kernels for quantum_basis_tpu.
//
// Native equivalents of the reference's host combinatorics layer
// (reference wztzjhn/quantum_basis is all C++; these cover the rows the
// framework keeps on the host):
//   * compact_rows  — ELL row compaction (sort + duplicate-column merge),
//                     the host half of the sparse build (cf. lil_mat's
//                     sorted-insert accumulate, src/sparse.cc:44-111),
//                     multithreaded over rows;
//   * lin_solve     — BFS solve of Ja[ia] + Jb[ib] = j with validation
//                     (cf. ALGraph::BSF_set_JaJb, src/miscellaneous.cc:640-708);
//   * vec_write /
//     vec_read      — chunked binary vector I/O with CRC32 + length +
//                     file-size validation (cf. vec_disk_read/write,
//                     src/miscellaneous.cc:391-471).
//
// Exposed through the raw CPython API + buffer protocol (no pybind11 /
// numpy headers); quantum_basis_tpu.native wraps it with numpy views and
// falls back to pure numpy when the extension is unavailable.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- CRC32
uint32_t crc32_update(uint32_t crc, const unsigned char* buf, size_t len) {
    static uint32_t table[256];
    static bool init = false;
    if (!init) {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++)
                c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
            table[i] = c;
        }
        init = true;
    }
    crc = ~crc;
    for (size_t i = 0; i < len; i++)
        crc = table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
    return ~crc;
}

struct Buf {
    Py_buffer view{};
    bool ok = false;
    ~Buf() { if (ok) PyBuffer_Release(&view); }
    bool acquire(PyObject* obj, bool writable = false) {
        int flags = PyBUF_C_CONTIGUOUS | (writable ? PyBUF_WRITABLE : 0);
        if (PyObject_GetBuffer(obj, &view, flags) != 0) return false;
        ok = true;
        return true;
    }
};

// ------------------------------------------------------------ compact_rows
// cols (n, W) int64; vre (n, W) f64; vim (n, W) f64 or absent.
// Per row: drop |v| <= tol, sort by col, merge duplicates. Returns
// (width, cols_out, vre_out, vim_out) with invalid slots = col 0 / val 0.
constexpr int64_t KINVALID = int64_t(1) << 62;

void compact_range(int64_t* cols, double* vre, double* vim,
                   Py_ssize_t r0, Py_ssize_t r1, Py_ssize_t W, double tol,
                   int* rowmax) {
    std::vector<int> idx(W);
    std::vector<int64_t> c2(W);
    std::vector<double> vr2(W), vi2(W);
    int localmax = 0;
    for (Py_ssize_t r = r0; r < r1; r++) {
        int64_t* c = cols + r * W;
        double* ar = vre + r * W;
        double* ai = vim ? vim + r * W : nullptr;
        for (Py_ssize_t k = 0; k < W; k++) {
            double mag = std::abs(ar[k]) + (ai ? std::abs(ai[k]) : 0.0);
            if (!(mag > tol) || c[k] < 0) c[k] = KINVALID;
            idx[k] = int(k);
        }
        std::sort(idx.begin(), idx.begin() + W,
                  [&](int a, int b) { return c[a] < c[b]; });
        int w = 0;
        for (Py_ssize_t t = 0; t < W; t++) {
            int k = idx[t];
            if (c[k] == KINVALID) break;
            if (w > 0 && c2[w - 1] == c[k]) {
                vr2[w - 1] += ar[k];
                if (ai) vi2[w - 1] += ai[k];
            } else {
                c2[w] = c[k];
                vr2[w] = ar[k];
                if (ai) vi2[w] = ai[k];
                w++;
            }
        }
        // re-drop merged-to-zero entries
        int w2 = 0;
        for (int k = 0; k < w; k++) {
            double mag = std::abs(vr2[k]) + (ai ? std::abs(vi2[k]) : 0.0);
            if (mag > tol) {
                c2[w2] = c2[k];
                vr2[w2] = vr2[k];
                if (ai) vi2[w2] = vi2[k];
                w2++;
            }
        }
        for (int k = 0; k < w2; k++) {
            c[k] = c2[k];
            ar[k] = vr2[k];
            if (ai) ai[k] = vi2[k];
        }
        for (Py_ssize_t k = w2; k < W; k++) {
            c[k] = 0;
            ar[k] = 0.0;
            if (ai) ai[k] = 0.0;
        }
        if (w2 > localmax) localmax = w2;
    }
    *rowmax = localmax;
}

PyObject* py_compact_rows(PyObject*, PyObject* args) {
    PyObject *colso, *vreo, *vimo;
    Py_ssize_t n, W;
    double tol;
    if (!PyArg_ParseTuple(args, "OOOnnd", &colso, &vreo, &vimo, &n, &W, &tol))
        return nullptr;
    Buf bc, br, bi;
    if (!bc.acquire(colso, true) || !br.acquire(vreo, true)) return nullptr;
    bool has_im = vimo != Py_None;
    if (has_im && !bi.acquire(vimo, true)) return nullptr;
    auto* cols = static_cast<int64_t*>(bc.view.buf);
    auto* vre = static_cast<double*>(br.view.buf);
    auto* vim = has_im ? static_cast<double*>(bi.view.buf) : nullptr;

    int nth = int(std::min<Py_ssize_t>(std::thread::hardware_concurrency(),
                                       std::max<Py_ssize_t>(n / 4096, 1)));
    nth = std::max(nth, 1);
    std::vector<int> maxes(nth, 0);
    {
        Py_BEGIN_ALLOW_THREADS
        std::vector<std::thread> th;
        Py_ssize_t per = (n + nth - 1) / nth;
        for (int t = 0; t < nth; t++) {
            Py_ssize_t r0 = t * per, r1 = std::min<Py_ssize_t>(n, r0 + per);
            if (r0 >= r1) { maxes[t] = 0; continue; }
            th.emplace_back(compact_range, cols, vre, vim, r0, r1, W, tol,
                            &maxes[t]);
        }
        for (auto& x : th) x.join();
        Py_END_ALLOW_THREADS
    }
    int width = 0;
    for (int m : maxes) width = std::max(width, m);
    return PyLong_FromLong(width);
}

// ---------------------------------------------------------------- lin_solve
PyObject* py_lin_solve(PyObject*, PyObject* args) {
    PyObject *iao, *ibo, *jao, *jbo;
    Py_ssize_t n, sa, sb;
    if (!PyArg_ParseTuple(args, "OOnnnOO", &iao, &ibo, &n, &sa, &sb, &jao,
                          &jbo))
        return nullptr;
    Buf bia, bib, bja, bjb;
    if (!bia.acquire(iao) || !bib.acquire(ibo) || !bja.acquire(jao, true) ||
        !bjb.acquire(jbo, true))
        return nullptr;
    auto* ia = static_cast<const int64_t*>(bia.view.buf);
    auto* ib = static_cast<const int64_t*>(bib.view.buf);
    auto* Ja = static_cast<int64_t*>(bja.view.buf);
    auto* Jb = static_cast<int64_t*>(bjb.view.buf);
    bool okret = true;
    Py_BEGIN_ALLOW_THREADS
    // adjacency: bucket edges by ia and by ib (CSR-ish)
    std::vector<int64_t> cnt_a(sa + 1, 0), cnt_b(sb + 1, 0);
    for (Py_ssize_t e = 0; e < n; e++) {
        cnt_a[ia[e] + 1]++;
        cnt_b[ib[e] + 1]++;
    }
    for (Py_ssize_t i = 0; i < sa; i++) cnt_a[i + 1] += cnt_a[i];
    for (Py_ssize_t i = 0; i < sb; i++) cnt_b[i + 1] += cnt_b[i];
    std::vector<int64_t> adj_a(n), adj_b(n), pos_a = cnt_a, pos_b = cnt_b;
    for (Py_ssize_t e = 0; e < n; e++) {
        adj_a[pos_a[ia[e]]++] = e;
        adj_b[pos_b[ib[e]]++] = e;
    }
    std::vector<signed char> ka(sa, 0), kb(sb, 0);
    std::fill(Ja, Ja + sa, 0);
    std::fill(Jb, Jb + sb, 0);
    std::vector<int64_t> stack;  // frontier of resolved edges
    stack.reserve(1024);
    for (Py_ssize_t seed = 0; seed < n; seed++) {
        if (ka[ia[seed]] || kb[ib[seed]]) continue;
        ka[ia[seed]] = 1;  // gauge: Ja = 0 on the component root
        Ja[ia[seed]] = 0;
        stack.push_back(seed);
        while (!stack.empty()) {
            int64_t e = stack.back();
            stack.pop_back();
            int64_t a = ia[e], b = ib[e];
            if (ka[a] && !kb[b]) {
                Jb[b] = e - Ja[a];
                kb[b] = 1;
                for (int64_t t = cnt_b[b]; t < cnt_b[b + 1]; t++)
                    stack.push_back(adj_b[t]);
            } else if (kb[b] && !ka[a]) {
                Ja[a] = e - Jb[b];
                ka[a] = 1;
                for (int64_t t = cnt_a[a]; t < cnt_a[a + 1]; t++)
                    stack.push_back(adj_a[t]);
            }
        }
    }
    for (Py_ssize_t e = 0; e < n; e++) {
        if (Ja[ia[e]] + Jb[ib[e]] != e) {
            okret = false;
            break;
        }
    }
    Py_END_ALLOW_THREADS
    if (!okret) {
        PyErr_SetString(PyExc_ValueError, "inconsistent Lin constraints");
        return nullptr;
    }
    Py_RETURN_NONE;
}

// ------------------------------------------------------------- vec I/O
constexpr size_t CHUNK = size_t(1) << 20;  // 1 MiB, like the reference

PyObject* py_vec_write(PyObject*, PyObject* args) {
    const char* path;
    PyObject* datao;
    if (!PyArg_ParseTuple(args, "sO", &path, &datao)) return nullptr;
    Buf bd;
    if (!bd.acquire(datao)) return nullptr;
    auto* data = static_cast<const unsigned char*>(bd.view.buf);
    uint64_t nbytes = uint64_t(bd.view.len);
    uint32_t crc = 0;
    FILE* f = fopen(path, "wb");
    if (!f) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }
    bool okw = true;
    Py_BEGIN_ALLOW_THREADS
    okw = fwrite(&nbytes, sizeof(nbytes), 1, f) == 1;
    for (uint64_t off = 0; okw && off < nbytes; off += CHUNK) {
        size_t len = size_t(std::min<uint64_t>(CHUNK, nbytes - off));
        crc = crc32_update(crc, data + off, len);
        okw = fwrite(data + off, 1, len, f) == len;
    }
    if (okw) okw = fwrite(&crc, sizeof(crc), 1, f) == 1;
    Py_END_ALLOW_THREADS
    fclose(f);
    if (!okw) {
        PyErr_SetString(PyExc_OSError, "short write");
        return nullptr;
    }
    Py_RETURN_NONE;
}

PyObject* py_vec_read(PyObject*, PyObject* args) {
    const char* path;
    if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
    FILE* f = fopen(path, "rb");
    if (!f) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }
    uint64_t nbytes = 0;
    if (fread(&nbytes, sizeof(nbytes), 1, f) != 1) {
        fclose(f);
        PyErr_SetString(PyExc_ValueError, "truncated header");
        return nullptr;
    }
    // validate file size: header + payload + crc
    long here = ftell(f);
    fseek(f, 0, SEEK_END);
    long fsize = ftell(f);
    fseek(f, here, SEEK_SET);
    if (uint64_t(fsize) != sizeof(uint64_t) + nbytes + sizeof(uint32_t)) {
        fclose(f);
        PyErr_SetString(PyExc_ValueError, "file size mismatch");
        return nullptr;
    }
    PyObject* out = PyBytes_FromStringAndSize(nullptr, Py_ssize_t(nbytes));
    if (!out) {
        fclose(f);
        return nullptr;
    }
    auto* data = reinterpret_cast<unsigned char*>(PyBytes_AS_STRING(out));
    uint32_t crc = 0;
    bool okr = true;
    Py_BEGIN_ALLOW_THREADS
    for (uint64_t off = 0; okr && off < nbytes; off += CHUNK) {
        size_t len = size_t(std::min<uint64_t>(CHUNK, nbytes - off));
        okr = fread(data + off, 1, len, f) == len;
        if (okr) crc = crc32_update(crc, data + off, len);
    }
    Py_END_ALLOW_THREADS
    uint32_t stored = 0;
    if (okr) okr = fread(&stored, sizeof(stored), 1, f) == 1;
    fclose(f);
    if (!okr || stored != crc) {
        Py_DECREF(out);
        PyErr_SetString(PyExc_ValueError, okr ? "CRC mismatch" : "short read");
        return nullptr;
    }
    return out;
}

PyMethodDef methods[] = {
    {"compact_rows", py_compact_rows, METH_VARARGS,
     "In-place ELL row compaction; returns max row width."},
    {"lin_solve", py_lin_solve, METH_VARARGS,
     "BFS solve of Ja[ia]+Jb[ib]=j into preallocated Ja/Jb."},
    {"vec_write", py_vec_write, METH_VARARGS,
     "CRC32-checked chunked binary write."},
    {"vec_read", py_vec_read, METH_VARARGS,
     "CRC32-checked chunked binary read -> bytes."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "qbx_native",
                         "native host kernels for quantum_basis_tpu",
                         -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_qbx_native(void) { return PyModule_Create(&moduledef); }
