// fastcall: calls a launcher of the package's CUDA libraries from Python
// without ctypes.
//
// Every launcher in csrc/ has the one C signature
//     extern "C" int name(const long long* a, int n)
// and takes its device pointers, sizes, flags and, last, its CUDA stream
// as n 64-bit integers (see fluctus_tpu_torch/launch.py). call(address,
// *args) converts each Python int once into an array on the stack and
// calls the launcher at `address`, returning its int result. ctypes
// instead builds a converter object per argument, which costs more than
// the launch itself for a wrapper with twenty arguments.
//
// One METH_FASTCALL function and no torch headers, so the host compiler
// builds it in about a second.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

namespace {

constexpr Py_ssize_t kMaxArgs = 32;
typedef int (*Launcher)(const long long*, int);

PyObject* call(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs < 1 || nargs > kMaxArgs + 1) {
    PyErr_Format(PyExc_TypeError,
                 "call(address, *args) takes 1 to %d arguments, got %zd",
                 (int)kMaxArgs + 1, nargs);
    return nullptr;
  }
  void* addr = PyLong_AsVoidPtr(args[0]);
  if (addr == nullptr) {
    if (!PyErr_Occurred())
      PyErr_SetString(PyExc_ValueError, "call: null launcher address");
    return nullptr;
  }
  long long a[kMaxArgs];
  for (Py_ssize_t i = 1; i < nargs; ++i) {
    a[i - 1] = PyLong_AsLongLong(args[i]);
    if (a[i - 1] == -1 && PyErr_Occurred()) return nullptr;
  }
  const int rc = reinterpret_cast<Launcher>(addr)(a, (int)(nargs - 1));
  return PyLong_FromLong(rc);
}

PyMethodDef kMethods[] = {
    {"call", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(
                 call)),
     METH_FASTCALL, "call(address, *args) -> the launcher's int result"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "fastcall",
                       "Calls the package's CUDA launchers.", -1, kMethods,
                       nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit_fastcall(void) { return PyModule_Create(&kModule); }
