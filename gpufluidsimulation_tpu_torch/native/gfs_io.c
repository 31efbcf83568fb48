/* gfs_io — native IO runtime for gpufluidsimulation_tpu_torch (the
 * PyTorch/CUDA port; a copy of the JAX package's native/gfs_io.c).
 *
 * The reference's IO path is C++ (utils/writeBMP.cpp, the OpenVDB
 * dense->sparse conversion in utils/volumeMeshTools.h:33-60). This module is
 * its counterpart here: a CPython extension providing
 *
 *   pack_sparse(buf, shape, voxel_size, threshold) -> bytes
 *       single-pass dense->sparse COO packing of a float32 volume into the
 *       .gfsvol container (releases the GIL; ~4x the numpy mask+argwhere
 *       path and no boolean temporaries);
 *
 *   async_write(path, payload) / flush()
 *       a background pthread writer queue so simulation frames are encoded
 *       and persisted without blocking the Python thread driving the GPU
 *       (SURVEY.md §7 hard part 6: "double-buffered async pipeline so the
 *       sim never blocks on I/O").
 *
 * .gfsvol layout (little-endian):
 *   char[4] magic "GFSV" | u32 version=1 | u32 nx, ny, nz | f32 voxel_size
 *   | u64 count | count * { u32 linear_index; f32 value }
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* sparse packing                                                      */
/* ------------------------------------------------------------------ */

typedef struct {
    char magic[4];
    uint32_t version;
    uint32_t nx, ny, nz;
    float voxel_size;
    uint64_t count;
} __attribute__((packed)) GfsVolHeader;

static PyObject *
pack_sparse(PyObject *self, PyObject *args)
{
    Py_buffer buf;
    unsigned int nx, ny, nz;
    float voxel_size, threshold;
    if (!PyArg_ParseTuple(args, "y*(III)ff", &buf, &nx, &ny, &nz,
                          &voxel_size, &threshold))
        return NULL;

    size_t n = (size_t)nx * ny * nz;
    if ((size_t)buf.len < n * sizeof(float)) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, "buffer smaller than shape");
        return NULL;
    }
    const float *dense = (const float *)buf.buf;

    uint64_t count = 0;
    uint32_t *idx = NULL;
    float *vals = NULL;

    Py_BEGIN_ALLOW_THREADS
    /* pass 1: count actives */
    for (size_t i = 0; i < n; i++)
        if (dense[i] > threshold) count++;
    idx = (uint32_t *)malloc(count ? count * sizeof(uint32_t) : 1);
    vals = (float *)malloc(count ? count * sizeof(float) : 1);
    if (idx && vals) {
        uint64_t k = 0;
        /* bound k to the pass-1 count: a writable buffer mutated between
         * the two passes (the GIL is released here) must not overflow the
         * allocations */
        for (size_t i = 0; i < n && k < count; i++) {
            if (dense[i] > threshold) {
                idx[k] = (uint32_t)i;
                vals[k] = dense[i];
                k++;
            }
        }
        count = k; /* shrink if fewer actives on pass 2 */
    }
    Py_END_ALLOW_THREADS

    PyBuffer_Release(&buf);
    if (!idx || !vals) {
        free(idx);
        free(vals);
        return PyErr_NoMemory();
    }

    size_t payload = sizeof(GfsVolHeader) + count * (sizeof(uint32_t) + sizeof(float));
    PyObject *out = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)payload);
    if (!out) {
        free(idx);
        free(vals);
        return NULL;
    }
    char *p = PyBytes_AS_STRING(out);
    GfsVolHeader hdr;
    memcpy(hdr.magic, "GFSV", 4);
    hdr.version = 1;
    hdr.nx = nx; hdr.ny = ny; hdr.nz = nz;
    hdr.voxel_size = voxel_size;
    hdr.count = count;
    memcpy(p, &hdr, sizeof(hdr));
    memcpy(p + sizeof(hdr), idx, count * sizeof(uint32_t));
    memcpy(p + sizeof(hdr) + count * sizeof(uint32_t), vals, count * sizeof(float));
    free(idx);
    free(vals);
    return out;
}

/* ------------------------------------------------------------------ */
/* async writer queue                                                  */
/* ------------------------------------------------------------------ */

typedef struct WriteJob {
    char *path;
    char *data;
    size_t len;
    struct WriteJob *next;
} WriteJob;

static pthread_mutex_t q_lock = PTHREAD_MUTEX_INITIALIZER;
static pthread_cond_t q_cond = PTHREAD_COND_INITIALIZER;
static pthread_cond_t q_drained = PTHREAD_COND_INITIALIZER;
static WriteJob *q_head = NULL, *q_tail = NULL;
static int q_inflight = 0;
static int writer_started = 0;
static uint64_t q_errors = 0;

static void *
writer_main(void *arg)
{
    (void)arg;
    for (;;) {
        pthread_mutex_lock(&q_lock);
        while (!q_head)
            pthread_cond_wait(&q_cond, &q_lock);
        WriteJob *job = q_head;
        q_head = job->next;
        if (!q_head) q_tail = NULL;
        pthread_mutex_unlock(&q_lock);

        FILE *f = fopen(job->path, "wb");
        if (f) {
            if (fwrite(job->data, 1, job->len, f) != job->len)
                __atomic_add_fetch(&q_errors, 1, __ATOMIC_RELAXED);
            fclose(f);
        } else {
            __atomic_add_fetch(&q_errors, 1, __ATOMIC_RELAXED);
        }
        free(job->path);
        free(job->data);
        free(job);

        pthread_mutex_lock(&q_lock);
        q_inflight--;
        if (q_inflight == 0)
            pthread_cond_broadcast(&q_drained);
        pthread_mutex_unlock(&q_lock);
    }
    return NULL;
}

static PyObject *
async_write(PyObject *self, PyObject *args)
{
    const char *path;
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "sy*", &path, &buf))
        return NULL;

    WriteJob *job = (WriteJob *)malloc(sizeof(WriteJob));
    if (!job) {
        PyBuffer_Release(&buf);
        return PyErr_NoMemory();
    }
    job->path = strdup(path);
    job->data = (char *)malloc(buf.len ? (size_t)buf.len : 1);
    job->len = (size_t)buf.len;
    job->next = NULL;
    if (!job->path || !job->data) {
        free(job->path); free(job->data); free(job);
        PyBuffer_Release(&buf);
        return PyErr_NoMemory();
    }
    memcpy(job->data, buf.buf, job->len);
    PyBuffer_Release(&buf);

    pthread_mutex_lock(&q_lock);
    if (!writer_started) {
        pthread_t tid;
        if (pthread_create(&tid, NULL, writer_main, NULL) != 0) {
            pthread_mutex_unlock(&q_lock);
            free(job->path); free(job->data); free(job);
            PyErr_SetString(PyExc_OSError, "cannot start writer thread");
            return NULL;
        }
        pthread_detach(tid);
        writer_started = 1;
    }
    if (q_tail) q_tail->next = job; else q_head = job;
    q_tail = job;
    q_inflight++;
    pthread_cond_signal(&q_cond);
    pthread_mutex_unlock(&q_lock);
    Py_RETURN_NONE;
}

static PyObject *
flush_queue(PyObject *self, PyObject *args)
{
    (void)args;
    Py_BEGIN_ALLOW_THREADS
    pthread_mutex_lock(&q_lock);
    while (q_inflight > 0)
        pthread_cond_wait(&q_drained, &q_lock);
    pthread_mutex_unlock(&q_lock);
    Py_END_ALLOW_THREADS
    return PyLong_FromUnsignedLongLong(
        __atomic_load_n(&q_errors, __ATOMIC_RELAXED));
}

static PyMethodDef Methods[] = {
    {"pack_sparse", pack_sparse, METH_VARARGS,
     "pack_sparse(f32_buffer, (nx,ny,nz), voxel_size, threshold) -> gfsvol bytes"},
    {"async_write", async_write, METH_VARARGS,
     "async_write(path, payload): enqueue a background file write"},
    {"flush", flush_queue, METH_NOARGS,
     "flush() -> error_count: wait for all queued writes"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "gfs_io", "native IO runtime", -1, Methods,
};

PyMODINIT_FUNC
PyInit_gfs_io(void)
{
    return PyModule_Create(&moduledef);
}
