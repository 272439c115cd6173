"""The profiling tools' kernel table (``tools/profile_sga.py``, shared by
``profile_bb`` and ``profile_train``) on a stand-in for a torch.profiler
window: no card needed."""

from types import SimpleNamespace

import pytest
import torch

from nic_tpu_torch.tools.profile_sga import kernel_table, summarize, table_lines


def _event(name, us, device=torch.autograd.DeviceType.CUDA, annotation=False):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                           time_range=SimpleNamespace(elapsed_us=lambda: us))


class _Window:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_kernel_table_counts_device_kernels_only():
    prof = _Window([
        _event("gdn_tc_kernel", 1000.0), _event("gdn_tc_kernel", 1000.0),
        _event("cudnn_conv_fprop_ffma", 3000.0),
        # An optimizer step's range on the device timeline, and a host op.
        _event("Optimizer.step#Adam.step", 5000.0, annotation=True),
        _event("aten::add", 7000.0, device=torch.autograd.DeviceType.CPU),
    ])
    kernels = kernel_table(prof)
    assert kernels == {"gdn_tc_kernel": [2.0, 2], "cudnn_conv_fprop_ffma": [3.0, 1]}

    s = summarize(kernels, steps=2, loop_ms=10.0)
    assert s["device_busy_ms_per_step"] == pytest.approx(2.5)
    assert s["device_idle_share"] == pytest.approx(0.5)
    assert s["kernels_per_step"] == pytest.approx(1.5)
    assert s["conv_tensor_core_share"] == 0.0
    assert list(s["categories"]) == ["convolution (cuDNN)", "K1 gdn kernel"]
    assert s["categories"]["K1 gdn kernel"] == pytest.approx(
        dict(ms_per_step=1.0, launches_per_step=1.0, share=0.4))

    lines = table_lines(kernels, steps=2)
    assert lines[1].split() == ["1.5000", "0.50", "convolution", "(cuDNN)", "|",
                                "cudnn_conv_fprop_ffma"]
    assert lines[2].endswith("K1 gdn kernel | gdn_tc_kernel")
