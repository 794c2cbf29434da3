"""FFT microbenchmarks on the current jax backend.

Isolates the spectral building blocks of the solver step to localize where
time goes as the grid grows (the 256^3 regression, VERDICT round 1 #4):

  - rfftn/irfftn round trip (the 14-transform step is built from these)
  - c2c fftn/ifftn round trip (alternative formulation)
  - per-axis 1D batched FFTs (to see which axis is the slow one)
  - the spectral elementwise multiply at the reduced-spectrum shape

Timing: many reps CHAINED inside one dispatch via lax.scan (serial data
dependency), ended with block_until_ready, so per-dispatch overhead is amortized
(default 128 reps). Inputs are fp32 and complex values are formed on device inside
the jitted chain.

Usage: python tools/bench_fft.py [--sizes 128,256] [--reps 128]
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

def timeit(fn, x, reps: int) -> float:
    """Seconds per application of fn, chained x -> fn(x) reps times in one jit.

    fn must map an fp32 array to an fp32 array of the same shape."""

    @jax.jit
    def chained(v):
        return lax.scan(lambda c, _: (fn(c), None), v, None, length=reps)[0]

    jax.block_until_ready(chained(x))  # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready(chained(x))
    return (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="128,256")
    ap.add_argument("--reps", type=int, default=128)
    ap.add_argument("--which", default="all", help="comma list: rt,c2c,axes,r2c,mul,grad")
    args = ap.parse_args()
    which = set(args.which.split(","))
    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind} x{len(jax.devices())}  reps={args.reps}",
          flush=True)

    for n in (int(s) for s in args.sizes.split(",")):
        shape = (n, n, n)
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
        gb = x.size * 4 / 1e9
        reps = args.reps

        if "rt" in which or "all" in which:
            t = timeit(lambda v: jnp.fft.irfftn(jnp.fft.rfftn(v), s=shape), x, reps)
            print(f"  {n}^3 rfftn+irfftn  : {t*1e3:8.3f} ms  ({2*gb/t:7.1f} GB/s eff)",
                  flush=True)

        if "c2c" in which or "all" in which:
            t = timeit(
                lambda v: jnp.real(jnp.fft.ifftn(jnp.fft.fftn(v.astype(jnp.complex64)))),
                x, reps,
            )
            print(f"  {n}^3 fftn+ifftn c2c: {t*1e3:8.3f} ms", flush=True)

        if "axes" in which or "all" in which:
            for ax in range(3):
                t = timeit(
                    lambda v, a=ax: jnp.real(
                        jnp.fft.ifft(jnp.fft.fft(v.astype(jnp.complex64), axis=a), axis=a)
                    ),
                    x, reps,
                )
                print(f"  {n}^3 1D c2c axis={ax}: {t*1e3:8.3f} ms", flush=True)

        if "r2c" in which or "all" in which:
            t = timeit(
                lambda v: jnp.fft.irfft(jnp.fft.rfft(v, axis=-1), n=n, axis=-1), x, reps
            )
            print(f"  {n}^3 1D r2c axis=-1: {t*1e3:8.3f} ms", flush=True)

        if "mul" in which or "all" in which:
            # elementwise complex multiply at the reduced-spectrum shape, complex formed
            # on device from fp32 planes
            r = n // 2 + 1
            kre = jnp.asarray(rng.standard_normal((n, n, r)).astype(np.float32))

            def mul(v):
                vk = lax.complex(v[..., :r], v[..., : r])
                out = vk * lax.complex(kre, kre)
                return jnp.concatenate(
                    [jnp.real(out), jnp.imag(out)[..., : n - r]], axis=-1
                )

            t = timeit(mul, x, reps)
            print(f"  {n}^3 cplx spectral mul (reduced) : {t*1e3:8.3f} ms", flush=True)

        if "grad" in which or "all" in which:
            # the solver's _grad_fields pattern: 1 rfftn + 3 spectral muls + 3 irfftn
            kre = jnp.asarray(rng.standard_normal((n, n, n // 2 + 1)).astype(np.float32))

            def grad(v):
                fk = jnp.fft.rfftn(v) * kre
                gx = jnp.fft.irfftn(fk * 1.001, s=shape)
                gy = jnp.fft.irfftn(fk * 0.999, s=shape)
                gz = jnp.fft.irfftn(fk * 1.0001, s=shape)
                return (gx + gy + gz) * (1.0 / 3.0)

            t = timeit(grad, x, max(reps // 2, 8))
            print(f"  {n}^3 grad (1 rfftn + 3 irfftn)    : {t*1e3:8.3f} ms", flush=True)


if __name__ == "__main__":
    main()
