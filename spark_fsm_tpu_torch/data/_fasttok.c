/* Native tokenizer for the data layer: a copy of
 * spark_fsm_tpu/data/_fasttok.c.
 *
 * build_vertical flattens a SequenceDB (a Python list of tuples of tuples
 * of ints) into token arrays; done by a Python generator chain, that pass
 * is the largest host stage of the vertical build.  This extension walks
 * the object graph once in C and returns the three arrays as raw
 * little-endian buffers:
 *
 *   flatten(db) -> (lengths: bytes of int32[n_seq]   -- itemsets per seq,
 *                   counts:  bytes of int64[n_sets]  -- items per itemset,
 *                   items:   bytes of int64[n_toks]) -- item ids, in order
 *
 * The Python wrapper (data/fasttok.py) wraps them with np.frombuffer; the
 * callers fall back to the numpy flatten whenever this module cannot be
 * built -- byte-identical results either way (tested).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>

static PyObject *
flatten(PyObject *self, PyObject *arg)
{
    PyObject *db = PySequence_Fast(arg, "db must be a sequence of sequences");
    if (db == NULL)
        return NULL;

    Py_ssize_t n_seq = PySequence_Fast_GET_SIZE(db);
    Py_ssize_t n_sets = 0, n_toks = 0;

    /* pass 1: sizes.  Container sizes are re-read every iteration before
     * each unchecked GET_ITEM macro read: PySequence_Size below can
     * re-enter Python (__len__), and a re-entrant callback shrinking a
     * borrowed list would otherwise turn GET_ITEM into a read past the
     * new size -- undefined behavior before any write guard exists. */
    for (Py_ssize_t i = 0; i < n_seq; i++) {
        if (i >= PySequence_Fast_GET_SIZE(db)) {
            PyErr_SetString(PyExc_RuntimeError,
                            "db changed size during tokenizer pass 1");
            goto fail_db;
        }
        PyObject *seq = PySequence_Fast(
            PySequence_Fast_GET_ITEM(db, i), "sequence must be a sequence");
        if (seq == NULL)
            goto fail_db;
        Py_ssize_t ns = PySequence_Fast_GET_SIZE(seq);
        /* totals feed n_sets*8 / n_toks*8 byte counts below: cap them so
         * a lying __len__ cannot overflow signed Py_ssize_t (UB) — the
         * same adversarial inputs the re-read guards handle get a clean
         * error here too */
        if (ns > PY_SSIZE_T_MAX / 8 - n_sets) {
            Py_DECREF(seq);
            PyErr_SetString(PyExc_OverflowError,
                            "tokenizer size totals overflow");
            goto fail_db;
        }
        n_sets += ns;
        for (Py_ssize_t j = 0; j < ns; j++) {
            if (j >= PySequence_Fast_GET_SIZE(seq)) {
                Py_DECREF(seq);
                PyErr_SetString(PyExc_RuntimeError,
                                "sequence changed size during tokenizer "
                                "pass 1");
                goto fail_db;
            }
            Py_ssize_t sz = PySequence_Size(PySequence_Fast_GET_ITEM(seq, j));
            if (sz < 0) {
                Py_DECREF(seq);
                goto fail_db;
            }
            if (sz > PY_SSIZE_T_MAX / 8 - n_toks) {
                Py_DECREF(seq);
                PyErr_SetString(PyExc_OverflowError,
                                "tokenizer size totals overflow");
                goto fail_db;
            }
            n_toks += sz;
        }
        Py_DECREF(seq);
    }

    PyObject *lengths = PyBytes_FromStringAndSize(NULL, n_seq * 4);
    PyObject *counts = PyBytes_FromStringAndSize(NULL, n_sets * 8);
    PyObject *items = PyBytes_FromStringAndSize(NULL, n_toks * 8);
    if (lengths == NULL || counts == NULL || items == NULL)
        goto fail_bufs;

    int32_t *lp = (int32_t *)PyBytes_AS_STRING(lengths);
    int64_t *cp = (int64_t *)PyBytes_AS_STRING(counts);
    int64_t *ip = (int64_t *)PyBytes_AS_STRING(items);
    /* Pass-2 sizes can disagree with pass 1 for adversarial inputs (a
     * lazy sequence whose __len__ lies, or Python code re-entered via an
     * item's __index__ mutating the db) — every write is bounds-checked
     * against the pass-1 totals so a mismatch raises instead of
     * corrupting the heap or returning garbage tails. */
    int32_t *lp_end = lp + n_seq;
    int64_t *cp_end = cp + n_sets;
    int64_t *ip_end = ip + n_toks;

    /* pass 2: fill.  Same re-read-before-GET_ITEM discipline as pass 1
     * (here PyLong_AsLongLong can re-enter via an item's __index__);
     * size drift bails to fail_mutated like the write guards. */
    for (Py_ssize_t i = 0; i < n_seq; i++) {
        if (i >= PySequence_Fast_GET_SIZE(db))
            goto fail_mutated;
        PyObject *seq = PySequence_Fast(
            PySequence_Fast_GET_ITEM(db, i), "sequence must be a sequence");
        if (seq == NULL)
            goto fail_bufs;
        Py_ssize_t ns = PySequence_Fast_GET_SIZE(seq);
        if (lp >= lp_end || cp + ns > cp_end) {
            Py_DECREF(seq);
            goto fail_mutated;
        }
        *lp++ = (int32_t)ns;
        for (Py_ssize_t j = 0; j < ns; j++) {
            if (j >= PySequence_Fast_GET_SIZE(seq)) {
                Py_DECREF(seq);
                goto fail_mutated;
            }
            PyObject *iset = PySequence_Fast(
                PySequence_Fast_GET_ITEM(seq, j), "itemset must be a sequence");
            if (iset == NULL) {
                Py_DECREF(seq);
                goto fail_bufs;
            }
            Py_ssize_t sz = PySequence_Fast_GET_SIZE(iset);
            if (ip + sz > ip_end) {
                Py_DECREF(iset);
                Py_DECREF(seq);
                goto fail_mutated;
            }
            *cp++ = (int64_t)sz;
            for (Py_ssize_t k = 0; k < sz; k++) {
                if (k >= PySequence_Fast_GET_SIZE(iset)) {
                    Py_DECREF(iset);
                    Py_DECREF(seq);
                    goto fail_mutated;
                }
                int64_t v = PyLong_AsLongLong(
                    PySequence_Fast_GET_ITEM(iset, k));
                if (v == -1 && PyErr_Occurred()) {
                    Py_DECREF(iset);
                    Py_DECREF(seq);
                    goto fail_bufs;
                }
                *ip++ = v;
            }
            Py_DECREF(iset);
        }
        Py_DECREF(seq);
    }
    if (lp != lp_end || cp != cp_end || ip != ip_end)
        goto fail_mutated;  /* under-filled: garbage tails, refuse */

    Py_DECREF(db);
    PyObject *out = PyTuple_Pack(3, lengths, counts, items);
    Py_DECREF(lengths);
    Py_DECREF(counts);
    Py_DECREF(items);
    return out;

fail_mutated:
    PyErr_SetString(PyExc_RuntimeError,
                    "db changed size between tokenizer passes");
fail_bufs:
    Py_XDECREF(lengths);
    Py_XDECREF(counts);
    Py_XDECREF(items);
fail_db:
    Py_DECREF(db);
    return NULL;
}

static PyMethodDef methods[] = {
    {"flatten", flatten, METH_O,
     "flatten(db) -> (lengths_i32_bytes, counts_i64_bytes, items_i64_bytes)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fasttok", NULL, -1, methods,
};

PyMODINIT_FUNC
PyInit__fasttok(void)
{
    return PyModule_Create(&moduledef);
}
