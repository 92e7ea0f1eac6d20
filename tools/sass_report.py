"""What nvcc made of a kernel source: per kernel, its registers and spills
(``-Xptxas -v``) and, from its SASS (``cuobjdump -sass``), the counts of
the instructions that tell a row kernel's design apart (16-byte loads and
stores, local loads and stores, the division's ``MUFU.RCP``/``FCHK`` and
the ``CALL`` to its slow path, K2's int-to-float conversions ``I2F``) and
how many of its global loads come after the first ``FMNMX`` (the absmax:
none where a row's loads are all issued before any use), after the first
``SHFL`` (its reduction) and after the first ``FMUL`` (K2's multiply by
the scale: none where its levels and scale are all loaded first).

    python3 tools/sass_report.py [SOURCE] [NAME_FILTER]

SOURCE is a path, or a file of ``src/repro_torch/kernels/csrc`` (default
``cut_layer.cu``), built with the port's nvcc flags into a temporary
directory (an earlier source from ``git show`` compares like with like); NAME_FILTER keeps the kernels whose demangled name holds it
(default ``vec_kernel``).  Needs the CUDA toolkit, not a card.
"""

import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build as B  # noqa: E402

COUNTED = ("LDG.E.128", "LDG.E.64", "STG.E.128", "STG.E.64", "LDL", "STL",
           "MUFU.RCP", "FCHK", "CALL", "I2F")


def ptxas_info(log: str) -> dict:
    """{mangled name: "registers R, spills S/L bytes"} from -Xptxas -v."""
    info, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            info[name] = f"spills {m.group(1)}/{m.group(2)} bytes"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            info[name] = f"{m.group(1)} registers, {info.get(name, '')}"
    return info


def sass_functions(sass: str) -> dict:
    """{mangled name: [instruction, ...]} from cuobjdump -sass."""
    funcs = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = part.split("\n", 1)
        funcs[name.strip()] = [s.strip() for s in re.findall(
            r"/\*[0-9a-f]{4}\*/\s+([^;]*);", body)]
    return funcs


def opcode(instruction: str) -> str:
    """The opcode of a SASS instruction, past its predicate."""
    words = instruction.split()
    return words[1] if words[0].startswith("@") else words[0]


def first(ops, prefix) -> int:
    """The index of the first opcode starting with ``prefix``."""
    return next((i for i, op in enumerate(ops) if op.startswith(prefix)),
                len(ops))


def main(source: str, keep: str) -> int:
    nvcc = Path(B._nvcc())
    path = Path(source) if Path(source).is_file() else B.CSRC / source
    with tempfile.TemporaryDirectory() as tmp:
        lib = Path(tmp) / "lib.so"
        built = subprocess.run(
            [str(nvcc), *B.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
             str(path)], capture_output=True, text=True)
        if built.returncode:
            print(built.stdout + built.stderr, file=sys.stderr)
            return 1
        info = ptxas_info(built.stdout + built.stderr)
        funcs = sass_functions(subprocess.run(
            [str(nvcc.parent / "cuobjdump"), "-sass", str(lib)],
            capture_output=True, text=True, check=True).stdout)
    names = list(funcs)
    plain = subprocess.run([str(nvcc.parent / "cu++filt")],
                           input="\n".join(names), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    for name, readable in sorted(zip(names, plain), key=lambda p: p[1]):
        if keep not in readable:
            continue
        ops = [opcode(s) for s in funcs[name]]
        counts = {k: sum(op.startswith(k) for op in ops) for k in COUNTED}
        loads = [i for i, op in enumerate(ops) if op.startswith("LDG")]
        after = [sum(i > first(ops, k) for i in loads)
                 for k in ("FMNMX", "SHFL", "FMUL")]
        kernel = readable[:readable.index(">(") + 1] if ">(" in readable \
            else readable.split("(")[0]
        print(f"{kernel}: {info.get(name, '?')}; "
              + ", ".join(f"{k} {v}" for k, v in counts.items())
              + f"; of its {len(loads)} LDG, {after[0]} after the first "
              f"FMNMX, {after[1]} after the first SHFL, {after[2]} after the "
              f"first FMUL")
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    sys.exit(main(args[0] if args else "cut_layer.cu",
                  args[1] if len(args) > 1 else "vec_kernel"))
