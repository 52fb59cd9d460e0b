"""The port's launch helper (fluctus_tpu_torch/launch.py) on the CPU: the
fastcall extension hands a launcher its 64-bit arguments in order and
returns its result, and `check` and every kernel wrapper raise on a
tensor the kernels do not take (a CPU, non-contiguous, mistyped or
misshapen one) before any launch. Launches themselves need the card
(tests/test_torch_kernels.py)."""
import ctypes

import pytest
import torch

from fluctus_tpu_torch import launch
from fluctus_tpu_torch.build import build_shared
from fluctus_tpu_torch.ops import probes
from fluctus_tpu_torch.ops import traverse_brute as tb
from fluctus_tpu_torch.ops import traverse_forest as tf
from fluctus_tpu_torch.ops import traverse_pallas as tp
from fluctus_tpu_torch.ops import traverse_stack as ts

# a launcher of the package's signature that folds its arguments in order
_FOLD = r'''
extern "C" int fold(const long long* a, int n) {
  long long s = n;
  for (int i = 0; i < n; ++i) s = (s * 31 + a[i]) % 1000003;
  return (int)s;
}
'''


def _fold(args):
    s = len(args)
    for a in args:
        s = (s * 31 + a) % 1000003
    return s


@pytest.fixture(scope="module")
def fold(tmp_path_factory):
    src = tmp_path_factory.mktemp("fold") / "fold.cpp"
    src.write_text(_FOLD)
    path, _, _ = build_shared(str(src), "fold_test",
                              ["g++", "-O2", "-shared", "-fPIC"])
    return launch.Launcher(ctypes.CDLL(path), "fold", "FOLD")


@pytest.mark.parametrize("args", [(), (7,), (1 << 47, -3, 0, 5),
                                  tuple(range(1, 33))])
def test_fastcall_passes_args_in_order(fold, args):
    assert launch.fastcall()(fold.addr, *args) == _fold(args)


def test_fastcall_refuses_bad_args(fold):
    call = launch.fastcall()
    with pytest.raises(TypeError):
        call(fold.addr, 1.5)
    with pytest.raises(TypeError):
        call(fold.addr, *range(33))          # one more than 32
    with pytest.raises(ValueError):
        call(0, 1)


def test_check_refuses():
    x = torch.zeros((4, 8))
    for bad in (x, x.t(), x.double(), x[:2]):
        with pytest.raises(ValueError, match="K9: x must be"):
            launch.check("K9", "x", bad, torch.float32, (4, 8))
    with pytest.raises(ValueError, match="not contiguous"):
        launch.check("K9", "x", x.t(), torch.float32, (8, 4))


def test_wrappers_refuse_cpu_tensors():
    """Each kernel wrapper raises on CPU (and non-contiguous) tensors, with
    its kernel's name, before it builds or launches anything."""
    x = torch.zeros((8, 128))
    with pytest.raises(ValueError, match="P1"):
        probes.copy_plus_one_kernel(x)
    with pytest.raises(ValueError, match="not contiguous"):
        probes.copy_plus_one_kernel(torch.zeros((128, 8)).t())
    with pytest.raises(ValueError, match="P2"):
        probes.fma_chain_kernel(torch.zeros((2, 256)), 1, True)
    o = torch.zeros((128, 3))
    bvh = type("W", (), {"nodes": torch.zeros((1, 56)),
                         "leaves": torch.zeros((1, 2, 10)), "leaf_width": 2,
                         "depth": 1, "root_ref": 0})()
    with pytest.raises(ValueError, match="K1"):
        ts.traverse_kernel(bvh, o, o, 1.0, any_hit=False)
    with pytest.raises(ValueError, match="K4"):
        tp.packet_kernel(torch.zeros((512, 3)), torch.zeros((512, 3)),
                         torch.zeros(512), bvh, False)
    i32 = torch.zeros((128, 1), dtype=torch.int32)
    f32 = torch.zeros((128, 1))
    rays8 = torch.zeros((128, 8))
    tris = torch.zeros((1, 16, 128))
    with pytest.raises(ValueError, match="K2"):
        tb.vlaunch_kernel(torch.zeros(8, dtype=torch.int32),
                          torch.zeros(8, dtype=torch.int32), tris,
                          torch.zeros((1, 8, 128)), rays8, f32, i32, f32,
                          f32, False, 128, 128, 8, 1)
    with pytest.raises(ValueError, match="K2: blk"):
        tb.vlaunch_kernel(None, None, tris, None, rays8, f32, i32, f32, f32,
                          False, 256, 128, 8, 1)
    with pytest.raises(ValueError, match="K3"):
        tb.launch_kernel(torch.zeros(1, dtype=torch.int32), tris,
                         torch.zeros((8, 128)), rays8, f32, i32, f32, f32,
                         False, 128, 128, 4, 1)
    with pytest.raises(ValueError, match="K5"):
        tf.launch_kernel(torch.zeros((1, 1), dtype=torch.int32),
                         torch.zeros((1, 1)), torch.zeros((1, 4, 56)),
                         torch.zeros((1, 4, 2, 10)), o, o, f32[:, 0],
                         i32[:, 0], f32[:, 0], f32[:, 0], False, 128, 2, 2)
