"""Time design variants of K5's window kernel beside the kept kernel, on
one NVIDIA GPU, at config 3's shapes (``examples/
config3_2048_maccormack_multigrid.json``: the velocity, f32 2 channels,
and the dye, bf16 3 channels, after 20 steps of ``make_step_render``).

    python3 tools/torch_k5_variants.py

Builds ``tools/torch_k5_variants.cu`` (which includes the kernel's source)
with the package's ``nvcc`` flags into ``build/k5_variants/``, checks the
variants that compute K5 bit-equal to the plain version, and prints CUDA-
event times (ms a call, the mean of 30 after 3 warm-ups, in two rounds)
for the kept kernel, the two-launch route and each variant, at config 3's
velocity and at one where the CFL clamp binds everywhere (full reach).
Imports nothing of JAX.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from esp32_fluid_simulation_tpu_torch import (  # noqa: E402
    SimConfig, init_state, make_step_render)
from esp32_fluid_simulation_tpu_torch.io_host.touch import (  # noqa: E402
    scripted_swirl)
from esp32_fluid_simulation_tpu_torch.ops.cuda import advect  # noqa: E402
from esp32_fluid_simulation_tpu_torch.ops.cuda.build import (  # noqa: E402
    NVCC_FLAGS, _nvcc)

VARIANTS = {"registers": 1, "bands": 2, "no ring (split)": 3,
            "forward only (split)": 4}
EXACT = ("registers", "bands")


def build():
    out = ROOT / "build" / "k5_variants"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libk5variants.so"
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(so),
                        str(ROOT / "tools" / "torch_k5_variants.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        sys.exit(r.stdout[-4000:] + r.stderr[-4000:])
    log = (r.stdout + r.stderr).splitlines()
    for a, line in enumerate(log):
        if "Compiling entry" in line and "variant_kernel" in line:
            regs = [x for x in log[a:a + 4] if "registers" in x]
            print("ptxas", line.split("'")[1][-40:],
                  regs[0].split(":", 1)[1].strip() if regs else "")
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.k5_variant.argtypes = (i, p, p, p, i, i, i, i, f, i, i, p)
    return lib


def ms(fn, n=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    lib = build()
    dev = torch.device("cuda", 0)
    cfg = SimConfig.from_json(
        (ROOT / "examples" / "config3_2048_maccormack_multigrid.json")
        .read_text())
    st = init_state(cfg, device=dev)
    step = make_step_render(cfg)
    for t in range(20):
        st, _ = step(st, scripted_swirl(cfg, t, device=dev))
    md, dt = cfg.advect_max_disp, cfg.dt
    gen = torch.Generator(device=dev).manual_seed(9)
    velocities = {"config 3": st.velocity,
                  "full reach": 2000.0 * torch.randn(
                      st.velocity.shape, generator=gen, device=dev)}
    fields = (("velocity", st.velocity, True), ("dye", st.color, False))

    def variant(var, field, vel, no_slip):
        out = torch.empty_like(field)
        err = lib.k5_variant(var, field.data_ptr(), vel.data_ptr(),
                             out.data_ptr(), *field.shape,
                             int(field.dtype == torch.bfloat16), dt, md,
                             int(no_slip),
                             torch.cuda.current_stream(field.device)
                             .cuda_stream)
        if err:
            raise RuntimeError(f"variant {var}: CUDA error {err}")
        return out

    bad = 0
    for vname, vel in velocities.items():
        for fname, field, ns in fields:
            field = vel if fname == "velocity" else field
            want = advect.advect_maccormack_reference(field, vel, dt, ns, md)
            for name in EXACT:
                got = variant(VARIANTS[name], field, vel, ns)
                same = torch.equal(got.view(torch.int16 if got.dtype ==
                                            torch.bfloat16 else torch.int32),
                                   want.view(torch.int16 if want.dtype ==
                                             torch.bfloat16 else
                                             torch.int32))
                print(f"{name} {fname} at {vname}: bit-equal {same}")
                bad += not same
    times = {}
    for _ in range(2):
        for vname, vel in velocities.items():
            for fname, field, ns in fields:
                field = vel if fname == "velocity" else field
                key = f"{fname} at {vname}"
                times.setdefault(f"kept, {key}", []).append(ms(
                    lambda: advect.advect_maccormack_kernel(field, vel, dt,
                                                            ns, md)))
                times.setdefault(f"two-launch route, {key}", []).append(ms(
                    lambda: advect._launch_two(field, vel, dt, ns, md,
                                               None)))
                for name, var in VARIANTS.items():
                    times.setdefault(f"{name}, {key}", []).append(ms(
                        lambda: variant(var, field, vel, ns)))
    print(f"ms a call on {card} (two rounds):")
    for k, v in times.items():
        print(f"  {k}: " + " / ".join(f"{x:.4f}" for x in v))
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
