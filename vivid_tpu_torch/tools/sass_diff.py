"""Compares the machine code of named kernels in two builds of the kernel
library, instruction for instruction.

    python -m vivid_tpu_torch.tools.sass_diff OLD.so NEW.so [--kernels flash_fwd_kernel,...]

Reads both libraries with the toolkit's `cuobjdump -sass`, takes every
function whose mangled name holds one of the kernel names (each template
instance apart, keyed by the name from the kernel's name on, which does not
depend on where the source was built), keeps its instructions without their
addresses and encodings, and prints for each instance whether the two lists
are the same. Exits 1 when one differs or is missing from either library.
Needs the CUDA toolkit, not a card.
"""

import argparse
import os
import re
import subprocess
import sys

from vivid_tpu_torch.kernels import build

KERNELS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel",   # K8
           "flash_nomax_kernel",                                                 # K6
           "flash_fused_kernel", "fused_norm_kernel")                            # K5
_INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]+\*/\s*(.*?)\s*;")   # "/*0010*/  MOV R1, R2 ;"


def functions(lib_path, kernels):
    """{key: [instruction, ...]} for every instance of `kernels` in the library."""
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    dump = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out, current = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            kernel = next((k for k in kernels if k in name), None)
            current = out.setdefault(name[name.index(kernel):], []) if kernel else None
        elif current is not None and (ins := _INSTRUCTION.match(line)):
            current.append(ins.group(1))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    args = ap.parse_args(argv)
    kernels = tuple(args.kernels.split(","))
    old, new = functions(args.old, kernels), functions(args.new, kernels)
    same = bool(old) and old.keys() == new.keys()
    for key in sorted(old.keys() | new.keys()):
        a, b = old.get(key), new.get(key)
        if a is None or b is None:
            print(f"{key[:90]}: only in {'new' if a is None else 'old'}")
            continue
        differ = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        same = same and differ == 0
        print(f"{key[:90]}: {len(a)} / {len(b)} instructions, "
              + ("identical" if differ == 0 else f"{differ} differ"))
    print(f"sass_diff: {len(old)} instances, {'all identical' if same else 'DIFFERENT'}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
