/* Length-prefixed frame codec — the native hot path of the host transport.
 *
 * Parity target: the reference's wire format is reactor-netty's 4-byte
 * LengthFieldPrepender / LengthFieldBasedFrameDecoder pair
 * (TransportImpl.java:383-397), which runs as native-backed Netty pipeline
 * stages. This CPython extension is the same component for the asyncio
 * backend: frame assembly/splitting runs in C against one contiguous
 * buffer, and the Python layer only sees whole payloads.
 *
 * API (mirrored by the pure-Python fallback in native/__init__.py):
 *   encode(payload: bytes, max_frame: int) -> bytes
 *   FrameAccumulator(max_frame).feed(chunk: bytes) -> list[bytes]
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

typedef struct {
    PyObject_HEAD
    uint8_t *buf;
    Py_ssize_t len;
    Py_ssize_t cap;
    Py_ssize_t max_frame;
    Py_ssize_t poisoned; /* oversized frame length; 0 = healthy */
} Accum;

static uint32_t read_be32(const uint8_t *p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

static int accum_init(Accum *self, PyObject *args, PyObject *kwds) {
    static char *kwlist[] = {"max_frame", NULL};
    Py_ssize_t max_frame = 2 * 1024 * 1024;
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "|n", kwlist, &max_frame))
        return -1;
    if (max_frame <= 0) {
        PyErr_SetString(PyExc_ValueError, "max_frame must be positive");
        return -1;
    }
    self->buf = NULL;
    self->len = 0;
    self->cap = 0;
    self->max_frame = max_frame;
    self->poisoned = 0;
    return 0;
}

static void accum_dealloc(Accum *self) {
    PyMem_Free(self->buf);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *accum_feed(Accum *self, PyObject *arg) {
    Py_buffer view;
    if (self->poisoned) {
        PyErr_Format(PyExc_ValueError,
                     "frame of %zd bytes exceeds max_frame %zd",
                     self->poisoned, self->max_frame);
        return NULL;
    }
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0)
        return NULL;

    /* Append the chunk (amortized doubling). */
    if (self->len + view.len > self->cap) {
        Py_ssize_t cap = self->cap ? self->cap : 4096;
        while (cap < self->len + view.len)
            cap *= 2;
        uint8_t *nbuf = PyMem_Realloc(self->buf, (size_t)cap);
        if (!nbuf) {
            PyBuffer_Release(&view);
            return PyErr_NoMemory();
        }
        self->buf = nbuf;
        self->cap = cap;
    }
    memcpy(self->buf + self->len, view.buf, (size_t)view.len);
    self->len += view.len;
    PyBuffer_Release(&view);

    PyObject *frames = PyList_New(0);
    if (!frames)
        return NULL;

    Py_ssize_t pos = 0;
    while (self->len - pos >= 4) {
        Py_ssize_t flen = (Py_ssize_t)read_be32(self->buf + pos);
        if (flen > self->max_frame) {
            /* Netty decode-loop contract: frames parsed earlier in this
             * chunk are still delivered; the stream is poisoned for any
             * further feed. */
            self->poisoned = flen;
            break;
        }
        if (self->len - pos - 4 < flen)
            break; /* incomplete frame: wait for more bytes */
        PyObject *payload =
            PyBytes_FromStringAndSize((const char *)self->buf + pos + 4, flen);
        if (!payload || PyList_Append(frames, payload) < 0) {
            Py_XDECREF(payload);
            Py_DECREF(frames);
            return NULL;
        }
        Py_DECREF(payload);
        pos += 4 + flen;
    }
    if (pos > 0) {
        memmove(self->buf, self->buf + pos, (size_t)(self->len - pos));
        self->len -= pos;
    }
    return frames;
}

static PyObject *accum_pending(Accum *self, PyObject *Py_UNUSED(ignored)) {
    return PyLong_FromSsize_t(self->len);
}

static PyObject *accum_poisoned(Accum *self, PyObject *Py_UNUSED(ignored)) {
    return PyLong_FromSsize_t(self->poisoned);
}

static PyMethodDef accum_methods[] = {
    {"feed", (PyCFunction)accum_feed, METH_O,
     "Append a chunk; return the list of completed frame payloads."},
    {"pending", (PyCFunction)accum_pending, METH_NOARGS,
     "Bytes buffered awaiting frame completion."},
    {"poisoned", (PyCFunction)accum_poisoned, METH_NOARGS,
     "Oversized frame length that poisoned the stream (0 = healthy)."},
    {NULL, NULL, 0, NULL}};

static PyTypeObject AccumType = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "_framing.FrameAccumulator",
    .tp_basicsize = sizeof(Accum),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "Streaming 4-byte-length-prefix frame splitter.",
    .tp_init = (initproc)accum_init,
    .tp_dealloc = (destructor)accum_dealloc,
    .tp_new = PyType_GenericNew,
    .tp_methods = accum_methods,
};

static PyObject *mod_encode(PyObject *Py_UNUSED(mod), PyObject *args) {
    Py_buffer view;
    Py_ssize_t max_frame;
    if (!PyArg_ParseTuple(args, "y*n", &view, &max_frame))
        return NULL;
    if (view.len > max_frame) {
        PyBuffer_Release(&view);
        return PyErr_Format(PyExc_ValueError,
                            "frame of %zd bytes exceeds max_frame %zd",
                            view.len, max_frame);
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, view.len + 4);
    if (!out) {
        PyBuffer_Release(&view);
        return NULL;
    }
    uint8_t *p = (uint8_t *)PyBytes_AS_STRING(out);
    uint32_t n = (uint32_t)view.len;
    p[0] = (uint8_t)(n >> 24);
    p[1] = (uint8_t)(n >> 16);
    p[2] = (uint8_t)(n >> 8);
    p[3] = (uint8_t)n;
    memcpy(p + 4, view.buf, (size_t)view.len);
    PyBuffer_Release(&view);
    return out;
}

static PyMethodDef mod_methods[] = {
    {"encode", mod_encode, METH_VARARGS,
     "encode(payload, max_frame) -> 4-byte-BE-length-prefixed bytes"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef framing_module = {
    PyModuleDef_HEAD_INIT, "_framing",
    "C frame codec for the scalecube_cluster_tpu host transport.", -1,
    mod_methods};

PyMODINIT_FUNC PyInit__framing(void) {
    PyObject *m;
    if (PyType_Ready(&AccumType) < 0)
        return NULL;
    m = PyModule_Create(&framing_module);
    if (!m)
        return NULL;
    Py_INCREF(&AccumType);
    if (PyModule_AddObject(m, "FrameAccumulator", (PyObject *)&AccumType) < 0) {
        Py_DECREF(&AccumType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
