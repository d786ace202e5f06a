"""`vivid_tpu_torch.tools.sass_diff` on canned `cuobjdump -sass` listings (the
toolkit is not needed): instances keyed apart from where the source was
built, addresses and encodings dropped, and the exit code set by whether
every instance matches."""

import types

import pytest

from vivid_tpu_torch.tools import sass_diff

_HEAD = "\tcode for sm_90a\n\t\tFunction : _ZN45_GLOBAL__N__{tag}_12_flash_bwd_cu_{tag}16{kernel}\n" \
        '\t.headerflags\t@"EF_CUDA_SM90"\n'


def _listing(tag, body, kernel="flash_fwd_kernelILi32ELb0EEEv"):
    lines = [_HEAD.format(tag=tag, kernel=kernel)]
    for i, ins in enumerate(body):
        lines.append(f"        /*{16 * i:04x}*/                   {ins} ;"
                     f"                    /* 0x{i:016x} */\n")
        lines.append(f"{' ' * 97}/* 0x000fe{i:011x} */\n")
    lines.append("        ..........\n")
    return "".join(lines)


@pytest.fixture
def dumps(monkeypatch):
    listings = {}
    monkeypatch.setattr(sass_diff.build, "find_nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(sass_diff.subprocess, "run", lambda cmd, **kw: types.SimpleNamespace(
        stdout=listings[cmd[-1]]))
    return listings


def test_functions_keys_instances_by_kernel_and_drops_addresses(dumps):
    dumps["a.so"] = _listing("83e499fc", ["LDC R1, c[0x0][0x28]", "EXIT"]) + _listing(
        "83e499fc", ["MOV R2, R3"], kernel="flash_fused_kernelILi32ELb0EEEv")
    got = sass_diff.functions("a.so", ("flash_fwd_kernel",))
    assert got == {"flash_fwd_kernelILi32ELb0EEEv": ["LDC R1, c[0x0][0x28]", "EXIT"]}


@pytest.mark.parametrize("new_body,new_kernel,rc", [
    (["LDC R1, c[0x0][0x28]", "EXIT"], "flash_fwd_kernelILi32ELb0EEEv", 0),   # built elsewhere
    (["LDC R1, c[0x0][0x2c]", "EXIT"], "flash_fwd_kernelILi32ELb0EEEv", 1),   # one differs
    (["LDC R1, c[0x0][0x28]", "EXIT"], "flash_fwd_kernelILi64ELb0EEEv", 1),   # instance missing
])
def test_main_exits_0_only_when_every_instance_matches(dumps, new_body, new_kernel, rc, capsys):
    dumps["old.so"] = _listing("83e499fc", ["LDC R1, c[0x0][0x28]", "EXIT"])
    dumps["new.so"] = _listing("1f00aa77", new_body, kernel=new_kernel)
    assert sass_diff.main(["old.so", "new.so"]) == rc
    assert ("all identical" in capsys.readouterr().out) == (rc == 0)


def test_default_kernels_are_k8_k6_and_k5(dumps):
    """Without --kernels the K8, K6 and K5 instances are compared (K5's norm
    pre-pass too), and nothing else of the library."""
    names = ["flash_fwd_kernelILi32ELb0EEEv", "flash_bwd_dkv_kernelILi64ELb1EEEv",
             "flash_bwd_dq_kernelILi32ELb1EEEv", "flash_nomax_kernelILi64ELb0EEEv",
             "flash_fused_kernelILi64ELb1EEEv", "fused_norm_kernelILi32EEEv"]
    dumps["lib.so"] = "".join(_listing("83e499fc", ["EXIT"], kernel=k) for k in names) + _listing(
        "83e499fc", ["EXIT"], kernel="conv3x3_silu_kernelILb1EEEv")
    assert sorted(sass_diff.functions("lib.so", sass_diff.KERNELS)) == sorted(names)
