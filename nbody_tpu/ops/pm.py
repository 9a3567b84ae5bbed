"""Particle-mesh (PM) force solver — the O(N log N) scaling tier above
the exact all-pairs kernels.

The reference is exact O(N^2) everywhere (ver0/GSimulation.cpp:130-150);
this module adds the standard mesh-based far-field solver as one more
entry in the kernel registry (the ver5_all backend seam, ops/registry.py)
so huge-N runs can trade bounded force error for an asymptotic win:

    a(x_i) = G * sum_j m_j * f(x_j - x_i),   f(r) = r / (|r|^2 + eps^2)^{3/2}

is a convolution of the mass field with the fixed Plummer-softened force
kernel f.  The method (Hockney & Eastwood's isolated-boundary PM):

1. **CIC deposit** — trilinear (cloud-in-cell) scatter of particle masses
   onto an ``ng^3`` grid spanning the particles' bounding box.
2. **FFT convolution on a doubled grid** — zero-pad to ``(2 ng)^3`` so the
   circular convolution equals the open-boundary one (vacuum boundaries,
   like the reference — NOT periodic), multiply the mass spectrum by the
   spectra of the three antisymmetric force-kernel components sampled on
   the same grid, and inverse-transform to per-axis acceleration grids.
3. **CIC gather** — trilinear interpolation of the acceleration grids
   back at each particle position.

**P3M** (``cutoff_cells > 0``; the ``p3m`` registry entry) upgrades the
one-level solver with Hockney & Eastwood's particle-particle
correction, in three exact-split pieces:

* the force is split f = f*S + f*(1-S) with a C^2 taper S(r^2/R_c^2)
  (_taper) — an exact identity, so no modeling error is introduced;
* the mesh solves the SMOOTH tapered part (plus, for cell-capacity
  overflow, the complement kernel — see below), with the CIC assignment
  window deconvolved in k-space (_cic_sharpen) so the mesh part is
  accurate to well beyond the taper scale;
* the compact-support residual (r < R_c ~ cutoff_cells grid spacings)
  is summed EXACTLY over slab-compact cell tables driven by a static
  worklist of dense (SLAB x SLAB) pair blocks (_sr_tables /
  _sr_worklist / _sr_sweep): particles sort into per-cell slabs of
  ``SLAB`` slots, every (target slab, in-reach source slab) pair
  becomes one worklist entry, and the sweep executes entries as dense
  pair blocks reading whole-slab rows — work scales with the
  OCCUPIED pair volume (clustered cores pay their occupancy^2, empty
  space pays nothing) and nothing gathers per particle.

Sources overflowing a cell's capacity are deposited on a second grid
convolved with the complement (short-range) kernel spectra: they get a
mesh-quality FULL force, so accuracy degrades toward plain PM, never
below it.  Measured (tests/test_p3m.py, docs/DESIGN.md "P3M"): Plummer
N=8192 rel L2 force error 0.43/0.18 (pm, ng=64/128) -> 4.3e-3/3.1e-3
(p3m); error scales ~ cutoff_cells^-3 (the accuracy knob), short-range
cost ~ cutoff_cells^3.

Why this is a good fit for the reference's force law: the softening
eps = sqrt(1e-3) ~ 0.032 is LARGE compared to a 128-grid spacing of the
unit initial box (h ~ 0.008), so the pair force is smooth on the grid
scale and the only error source is the CIC smoothing of sub-cell
positions — measured 8.5e-4 relative L2 force error at ng=128 (see
tests/test_pm.py and docs/DESIGN.md "Particle-mesh tier").

Structural properties (tested in tests/test_pm.py):
* **Exact momentum conservation and exactly zero self-force — when every
  particle is inside the mesh box** (the whole-distribution case for
  compact ICs): deposit and gather share the CIC weights and the sampled
  kernel is exactly antisymmetric, so each cloud-cell pair cancels its
  reaction, and a particle's own symmetric cloud convolved with the
  antisymmetric kernel is zero at the particle (same reason the
  reference's unmasked diagonal is zero).  When heavy-tail OUTLIERS
  exist, their per-octant monopole far field is approximate: momentum
  closes only to the outlier mass fraction, and an outlier sharing an
  octant with others feels a small self-term (a LONE outlier still has
  exactly zero self-force — its octant monopole sits at its own
  position).
* **Zero-mass padding is force- and energy-neutral** (weight 0, and
  excluded from the box like any massless particle).

Device mapping: the whole step is jnp — XLA batches the 8-corner
scatter (deposit) and gather, and the full-complex ``fftn``/``ifftn``
transforms run as XLA FFTs (cuFFT on a GPU).  FFT butterflies and
scatters are memory-bound library territory, not pair math, so there is
no hand-written kernel here.  The kernel spectra depend on the current
bounding box, so they are rebuilt inside the same jit (3 extra forward
FFTs) — no host round-trip, no dynamic shapes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..types import G_NEWTON, SOFTENING_SQUARED

DEFAULT_GRID = 128
# P3M split radius in CELL-LIST cells (R_c = cutoff_cells grid spacings,
# roughly): the short-range pass computes the exact softened residual for
# pairs closer than R_c, the mesh solves the tapered (smooth) remainder.
DEFAULT_CUTOFF_CELLS = 4


def _taper(q: jax.Array) -> jax.Array:
    """C^2 smoothstep S(q) in q = r^2/R_c^2: 0 at r=0, 1 at r>=R_c.

    The P3M force split is the exact identity
        f(r) = f(r)*S(q) + f(r)*(1 - S(q)),
    with the first (long-range) term solved on the mesh — S kills the
    sharp softened core, so f*S varies on the R_c scale the grid
    resolves — and the second (short-range, compact support r < R_c)
    term summed exactly over cell-list neighbors.  Working in q = r^2
    avoids a sqrt per pair: S is the quintic smoothstep in q, giving
    C^2 smoothness in r^2 (and ~r^6 flatness at the origin)."""
    q = jnp.clip(q, 0.0, 1.0)
    return q * q * q * (q * (q * 6.0 - 15.0) + 10.0)


def _cic_weights(pos, lo, inv_h, ng):
    """Grid coordinates and trilinear corner weights for pos (3, N).

    Returns (i0 (3,N) int32 lower-corner indices in [0, ng-2],
    frac (3,N) f32 in [0,1])."""
    # Clip in FLOAT first: far-away padding particles (state.pad_state's
    # 1e6 diagonal) produce grid coords way past int32 range, and
    # float->int conversion of out-of-range values is undefined in XLA.
    g = jnp.clip((pos - lo) * inv_h, 0.0, float(ng - 1))
    i0 = jnp.clip(jnp.floor(g).astype(jnp.int32), 0, ng - 2)
    frac = jnp.clip(g - i0.astype(jnp.float32), 0.0, 1.0)
    return i0, frac


def _corner_iter(i0, frac):
    """The 8 CIC corners: yields (flat-ish index triple, weight (N,))."""
    for cx in (0, 1):
        wx = frac[0] if cx else 1.0 - frac[0]
        for cy in (0, 1):
            wy = frac[1] if cy else 1.0 - frac[1]
            for cz in (0, 1):
                wz = frac[2] if cz else 1.0 - frac[2]
                yield (i0[0] + cx, i0[1] + cy, i0[2] + cz), wx * wy * wz


def _deposit(pos, mass, lo, inv_h, ng):
    """CIC scatter of masses onto an (ng, ng, ng) f32 grid."""
    i0, frac = _cic_weights(pos, lo, inv_h, ng)
    grid = jnp.zeros((ng, ng, ng), jnp.float32)
    for (ix, iy, iz), w in _corner_iter(i0, frac):
        grid = grid.at[ix, iy, iz].add(mass * w)
    return grid


def _gather(grids, pos, lo, inv_h, ng):
    """CIC interpolation of 3 (ng,ng,ng) grids at pos (3,N) -> (3,N).

    Gathers through FLAT 1-D indices, which XLA lowers to a simpler
    gather than 3-D advanced indexing."""
    i0, frac = _cic_weights(pos, lo, inv_h, ng)
    flat = grids.reshape(3, ng * ng * ng)
    out = jnp.zeros((3, pos.shape[1]), jnp.float32)
    for (ix, iy, iz), w in _corner_iter(i0, frac):
        out = out + w * flat[:, (ix * ng + iy) * ng + iz]
    return out


def _cic_sharpen(ng: int, m: int = 0):
    """Inverse squared CIC assignment window on an ``m``-point grid
    (default the doubled open-boundary grid, 2 ng; the periodic solver
    passes m = ng) — the Hockney & Eastwood influence-function
    compensation.  Deposit and
    gather each convolve with the CIC (order-2 B-spline) window, whose
    per-axis spectrum is sinc^2(pi f); dividing the force-kernel spectra
    by W^2 = prod_axis sinc^4 undoes that smoothing to leading order,
    removing the resolution-independent (h/R_c)^2 error floor of the
    tapered P3M kernel (measured: Plummer ng=128 1.7e-2 -> see
    docs/DESIGN.md).  The window is even and real, so the compensated
    kernel stays exactly antisymmetric: momentum conservation and zero
    self-force are untouched."""
    m = m or 2 * ng
    j = jnp.arange(m)
    jt = jnp.minimum(j, m - j).astype(jnp.float32)  # |signed freq index|
    x = jnp.pi * jt / m
    sinc = jnp.where(jt == 0, jnp.float32(1.0), jnp.sin(x) / x)
    inv = 1.0 / jnp.maximum(sinc, 1e-3) ** 4  # 1 / sinc^4 per axis
    return inv[:, None, None] * inv[None, :, None] * inv[None, None, :]


def _force_kernel_spectra(h, ng, rc2=None, complement=False, sharpen=False):
    """fftn spectra of the three Plummer-softened force-kernel components
    sampled on the doubled (2ng)^3 grid with signed wraparound
    displacements (Hockney open-boundary convolution kernel).

    ``h`` is the (3,) per-axis grid spacing (traced — the kernel follows
    the particles' bounding box).  With ``rc2`` (P3M mode) the sampled
    kernel is the tapered LONG-RANGE part f*S(r^2/rc2) only — smooth on
    the R_c scale, so CIC error collapses; the sub-R_c remainder is the
    short-range pass's job (see _taper).  ``complement=True`` samples the
    SHORT-RANGE part f*(1-S) instead — used to give capacity-overflowed
    sources a mesh-quality full force rather than a truncated one.
    P3M callers needing BOTH parts use _p3m_spectra below, which pays
    for one set of transforms instead of two.  The transforms are
    full-complex ``fftn``/``ifftn``."""
    m = 2 * ng
    idx = jnp.arange(m)
    # signed displacement in cells: 0..ng-1, then the negative half
    d = jnp.where(idx < ng, idx, idx - m).astype(jnp.float32)
    rx = (d * h[0])[:, None, None]
    ry = (d * h[1])[None, :, None]
    rz = (d * h[2])[None, None, :]
    r2 = rx * rx + ry * ry + rz * rz
    u = jax.lax.rsqrt(r2 + jnp.float32(SOFTENING_SQUARED))
    u3 = u * u * u  # 1 / (r^2 + eps^2)^{3/2}
    if rc2 is not None:
        s = _taper(r2 / rc2)
        u3 = u3 * (jnp.float32(1.0) - s if complement else s)
    w = _cic_sharpen(ng) if sharpen else jnp.float32(1.0)
    return (
        jnp.fft.fftn(rx * u3) * w,
        jnp.fft.fftn(ry * u3) * w,
        jnp.fft.fftn(rz * u3) * w,
    )


def _p3m_spectra(h, ng, rc2):
    """Tapered AND complement force-kernel spectra for one transform
    price: sample the FULL kernel and the complement, transform both
    (6 fftns), and recover the tapered part spectrally as full − comp
    (exact linear identity f*S = f − f*(1−S)).  Saves 3 of the 9
    per-step kernel fftns of the naive two-call formulation — measured
    on the mesh-bound p3m step.  Returns ((kx,ky,kz), (sx,sy,sz)),
    both CIC-sharpened."""
    fx, fy, fz = _force_kernel_spectra(h, ng, sharpen=True)
    sx, sy, sz = _force_kernel_spectra(h, ng, rc2=rc2, complement=True,
                                       sharpen=True)
    return (fx - sx, fy - sy, fz - sz), (sx, sy, sz)


# ---------------------------------------------------------------------------
# Periodic-box boundary mode (the cosmological convention)
# ---------------------------------------------------------------------------
#
# ``boundary="periodic"`` with a FIXED cubic box [0, L)^3 solves for the
# force of ALL periodic images minus the uniform background (the k=0 mode
# is dropped — the standard comoving-box convention; a fully periodic
# mass distribution has no preferred center, so only density CONTRASTS
# exert net force).  Differences from the open (vacuum-boundary) solver:
#
# * No doubled grid: the convolution is genuinely circular, so the FFTs
#   run on ng^3 instead of (2 ng)^3 — 8x less transform volume.
# * No per-step kernel transforms at all: the periodic force kernel has
#   the closed-form spectrum
#       phi_hat(k) = 4*pi * (eps*k) K1(eps*k) / k^2
#   (the FT of the Plummer potential (r^2+eps^2)^{-1/2}; K1 via the
#   polynomial approximations in _xk1), evaluated directly on the k
#   lattice — the Fourier-series coefficients of the image sum.  The
#   softening makes the kernel effectively band-limited (spectral decay
#   e^{-eps k}; at ng=128 on a unit box the Nyquist tail is ~6e-6), so
#   sampling the continuum spectrum on the lattice is essentially exact.
# * No robust box / outlier monopoles: every (wrapped) position is
#   in-box by construction.
# * No CIC sharpening, matching the open plain-PM choice (measured on
#   the k-space direct-sum reference: sharpening is a wash at ng>=64
#   and AMPLIFIES aliasing 2.8x at ng=32 where the kernel is not yet
#   band-limited).
#
# Accuracy vs the exact k-space sum (fp64 prototype, 16 random bodies,
# unit box): 3.7e-2 / 5.8e-3 / 5.1e-4 at ng=32/64/128 — the same
# CIC-limited scaling as the open solver.  Momentum conservation is
# exact (antisymmetric kernel).  Validated in tests/test_pm.py against
# an independent direct k-space sum (absolutely convergent thanks to
# the e^{-eps k} decay — softened gravity needs no Ewald split).


def _wrap_box(pos, box):
    """Fold positions into the canonical cell [0, box) per axis."""
    L = jnp.float32(box)
    return pos - L * jnp.floor(pos / L)


def _xk1(x):
    """g(x) = x * K1(x) (modified Bessel K1) for x >= 0, elementwise.

    Abramowitz & Stegun 9.8.3/9.8.7/9.8.8 polynomial approximations
    (abs err < 2.2e-7; validated against scipy.special.k1 in
    tests/test_pm.py).  g(0) = 1 and g ~ sqrt(pi x / 2) e^{-x} for
    large x — exactly the decay that makes the periodic Plummer
    spectrum band-limited."""
    x = jnp.asarray(x, jnp.float32)
    xs = jnp.maximum(x, jnp.float32(1e-12))
    t = (x * 0.5) ** 2
    u = (x / 3.75) ** 2
    # I1(x)/x (A&S 9.8.3, |x| <= 3.75; consumed only for x <= 2)
    i1x = (0.5 + u * (0.87890594 + u * (0.51498869 + u * (0.15084934
           + u * (0.02658733 + u * (0.00301532 + u * 0.00032411))))))
    small = (x * x * jnp.log(xs * 0.5) * i1x
             + 1.0 + t * (0.15443144 + t * (-0.67278579 + t * (-0.18156897
             + t * (-0.01919402 + t * (-0.00110404 + t * (-0.00004686)))))))
    w = 2.0 / jnp.maximum(x, jnp.float32(2.0))
    big = (jnp.sqrt(xs) * jnp.exp(-x)
           * (1.25331414 + w * (0.23498619 + w * (-0.03655620
              + w * (0.01504268 + w * (-0.00780353 + w * (0.00325614
              + w * (-0.00068245))))))))
    return jnp.where(x <= 2.0, small, big)


def _periodic_kvecs(box, ng: int):
    """Per-axis angular wavenumbers (ng,) f32 for the box's k lattice,
    in fftn layout (positive then negative frequencies)."""
    n = jnp.fft.fftfreq(ng, 1.0 / ng).astype(jnp.float32)
    return (2.0 * jnp.pi / jnp.float32(box)) * n


def _periodic_phi_spectrum(box, ng: int):
    """DFT spectrum (ng,ng,ng) f32 of the grid-sampled periodic Plummer
    POTENTIAL kernel: phi_hat(|k|) / h^3, with the k=0 mode zeroed
    (uniform-background subtraction).  The force spectra are the
    antisymmetric factors +i k_j applied per component at use site
    (_pm_force_grids_periodic) — storing one real scalar field instead
    of three complex ones."""
    f32 = jnp.float32
    k1d = _periodic_kvecs(box, ng)
    kx = k1d[:, None, None]
    ky = k1d[None, :, None]
    kz = k1d[None, None, :]
    k2 = kx * kx + ky * ky + kz * kz
    eps = jnp.sqrt(f32(SOFTENING_SQUARED))
    g = _xk1(eps * jnp.sqrt(k2))
    h3 = (f32(box) / f32(ng)) ** 3
    phi = jnp.where(k2 > 0,
                    4.0 * jnp.pi * g / jnp.maximum(k2, f32(1e-30)) / h3,
                    f32(0.0))
    return phi


def _pm_force_grids_periodic(rho_hat, box, ng: int):
    """Periodic-PM acceleration grids (3, ng, ng, ng): spectral
    multiply by +i k_j phi_hat (a = +grad of the potential sum under
    this module's a_i = sum_j m_j (x_j - x_i) u3 convention), one ifftn
    per component (full-complex transforms)."""
    phi = _periodic_phi_spectrum(box, ng)
    k1d = _periodic_kvecs(box, ng)
    axes = (k1d[:, None, None], k1d[None, :, None], k1d[None, None, :])
    return jnp.stack([
        jnp.fft.ifftn(rho_hat * (1j * kc * phi)).real for kc in axes])


def _cic_weights_periodic(pos, box, ng: int):
    """CIC lower corners (3,N) int32 in [0, ng-1] and fractions for
    WRAPPED positions on the periodic grid (h = box/ng; every cell is
    interior — corners wrap instead of clipping)."""
    f32 = jnp.float32
    g = _wrap_box(pos, box) * (f32(ng) / f32(box))
    i0 = jnp.clip(jnp.floor(g).astype(jnp.int32), 0, ng - 1)
    frac = jnp.clip(g - i0.astype(f32), 0.0, 1.0)
    return i0, frac


def _deposit_periodic(pos, mass, box, ng: int):
    """CIC scatter onto the periodic (ng,ng,ng) grid (corners wrap)."""
    i0, frac = _cic_weights_periodic(pos, box, ng)
    grid = jnp.zeros((ng * ng * ng,), jnp.float32)
    for (ix, iy, iz), w in _corner_iter(i0, frac):
        ix = jnp.where(ix >= ng, ix - ng, ix)
        iy = jnp.where(iy >= ng, iy - ng, iy)
        iz = jnp.where(iz >= ng, iz - ng, iz)
        grid = grid.at[(ix * ng + iy) * ng + iz].add(mass * w)
    return grid.reshape(ng, ng, ng)


def _gather_periodic(grids, pos, box, ng: int):
    """CIC interpolation of (k, ng, ng, ng) periodic grids at pos ->
    (k, N) (flat 1-D gather like _gather; corners wrap)."""
    i0, frac = _cic_weights_periodic(pos, box, ng)
    flat = grids.reshape(grids.shape[0], ng * ng * ng)
    out = jnp.zeros((grids.shape[0], pos.shape[1]), jnp.float32)
    for (ix, iy, iz), w in _corner_iter(i0, frac):
        ix = jnp.where(ix >= ng, ix - ng, ix)
        iy = jnp.where(iy >= ng, iy - ng, iy)
        iz = jnp.where(iz >= ng, iz - ng, iz)
        out = out + w * flat[:, (ix * ng + iy) * ng + iz]
    return out


# The <=7 image shifts a particle near a box corner needs (one face,
# two edges isn't possible — each axis contributes at most ONE shift
# direction since R_c < L/2, so the combinations are subsets of the
# per-axis signs).
_GHOST_COMBOS = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0),
                 (1, 0, 1), (0, 1, 1), (1, 1, 1))


def _ghost_combo_table():
    """(8, 7) lookup: row = bitmask of a particle's boundary axes
    (axis j sets bit j), column r = index into _GHOST_COMBOS of its
    r-th admissible shift combo (the nonempty subsets of the set
    bits, in _GHOST_COMBOS order; a mask with k set bits has 2^k - 1
    of them).  Unused tail columns repeat 0 — consumers mask by the
    per-particle ghost count before the entries matter."""
    cmb = [[0] * 7 for _ in range(8)]
    for mask in range(8):
        r = 0
        for idx, c in enumerate(_GHOST_COMBOS):
            cm = c[0] | (c[1] << 1) | (c[2] << 2)
            if cm and (cm & mask) == cm:
                cmb[mask][r] = idx
                r += 1
    return tuple(tuple(row) for row in cmb)


_GHOST_COMBO_TABLE = _ghost_combo_table()


def _default_ghost_cap(n: int) -> int:
    """Static ghost-slot bound when the caller gives none: 2N rounded to
    a power of two (a uniform box at the coarsest production cutoff
    R_c = L/8 measures ~0.95N images incl. edge/corner copies), capped
    at the guaranteed 7N.  DENSITY-BLIND like _auto_capacity — mass
    piled against a face can exceed it; callers with concrete data use
    suggest_sr_plan's measured count."""
    cap = 64
    while cap < 2 * n:
        cap *= 2
    return min(cap, 7 * n)


def _ghost_images(pos_w, mass, box, rc, gcap: int):
    """Periodic ghost images for the short-range pass.

    Every MASSIVE particle within R_c of a box face gets copies shifted
    by the relevant +-L combinations (<= 7: subsets of the per-axis
    shift signs, _GHOST_COMBOS), so every cross-boundary min-image
    neighbor pair becomes a DIRECT pair against some image — the
    open-boundary sweep kernels then apply unchanged, and a pair that
    is ALSO within R_c directly cannot double-count (its image copy
    sits at |d +- L| > L - R_c > R_c: exactly zero taper weight).
    Ghosts EXERT short-range force only; the forces they receive land
    in table slots nothing reads.

    Static-shape compaction: candidates pack into ``gcap`` slots;
    overflow beyond gcap is DROPPED.  Dropped ghosts are WORSE than
    cell overflow: their cross-boundary pairs lose the entire
    short-range term with NO complement compensation (the parent
    binned, so activating the complement would double-count its
    interior field — see _periodic_p3m_between's degradation contract),
    leaving tapered long-range-only, momentum-leaking forces on the
    affected boundary pairs.  Size gcap from suggest_sr_plan's measured
    count and check ghost_overflow_count when in doubt.  Returns
    (gpos (3, gcap), gmass (gcap,), n_ghost traced scalar).

    TWO-STAGE compaction, both stages gathers (a scatter over a
    candidate axis lowers to a sort, and candidate positions are never
    materialized either).  The round-5 single
    cumsum/searchsorted chain over all 7N (combo, particle) candidates
    was itself the dominant remaining ghost cost (~104 ms of the 1M
    periodic step, periodic_ab4_r5.log), so boundary PARTICLES compact
    first (one N-length cumsum into min(gcap, n) slots — each boundary
    particle yields >= 1 image, so a particle set that overflows gcap
    would overflow the ghost slots anyway), and ghost slots then decode
    (parent, rank) against the per-particle image counts 2^k - 1 with
    the (mask, rank) -> combo lookup _GHOST_COMBO_TABLE: the prefix
    chains shrink 7N -> N + min(gcap, n).  The packed image MULTISET
    is unchanged (order is particle-major instead of combo-major);
    n_ghost stays the exact total image count regardless of gcap."""
    f32, i32 = jnp.float32, jnp.int32
    L = jnp.float32(box)
    one = jnp.ones((), i32)
    n = pos_w.shape[1]
    sig = jnp.where(pos_w < rc, one,
                    jnp.where(pos_w > L - rc, -one, 0))  # (3, N)
    nz = sig != 0
    k = nz[0].astype(i32) + nz[1].astype(i32) + nz[2].astype(i32)
    live = (k > 0) & (mass > 0)
    gc = jnp.where(live, (one << k) - 1, 0)  # images per particle
    n_ghost = jnp.sum(gc)
    # Stage 1: compact the boundary particles.
    bcap = max(1, min(int(gcap), n))
    cumb = jnp.cumsum(live.astype(i32))
    bslots = jnp.arange(bcap, dtype=i32)
    bidx = jnp.minimum(jnp.searchsorted(cumb, bslots + 1, side="left"),
                       n - 1)
    bvalid = bslots < cumb[-1]
    sig_b = sig[:, bidx]  # (3, bcap)
    nzb = sig_b != 0
    k_b = nzb[0].astype(i32) + nzb[1].astype(i32) + nzb[2].astype(i32)
    gc_b = jnp.where(bvalid, (one << k_b) - 1, 0)
    cumg = jnp.cumsum(gc_b)
    mask_b = (nzb[0].astype(i32) + 2 * nzb[1].astype(i32)
              + 4 * nzb[2].astype(i32))
    # Stage 2: ghost slot -> (boundary parent p, image rank) -> combo.
    slots = jnp.arange(gcap, dtype=i32)
    p = jnp.minimum(jnp.searchsorted(cumg, slots + 1, side="left"),
                    bcap - 1)
    valid = slots < cumg[-1]
    rank = jnp.clip(slots - (cumg[p] - gc_b[p]), 0, 6)
    ci = jnp.asarray(_GHOST_COMBO_TABLE, i32)[mask_b[p], rank]
    pi = bidx[p]
    combos = jnp.asarray(_GHOST_COMBOS, i32).T  # (3, 7)
    shift_g = jnp.where(combos[:, ci] == 1, sig[:, pi], 0)  # (3, gcap)
    gpos = jnp.where(valid[None, :],
                     pos_w[:, pi] + L * shift_g.astype(f32), f32(0))
    gmass = jnp.where(valid, mass[pi], f32(0))
    return gpos, gmass, n_ghost


def _periodic_cells(ng: int, cutoff_cells: int):
    """Cell-list geometry for the periodic short-range pass: the core
    grid is ``nc`` cells across the box; ghost images extend it by
    ``sub`` cells per side (R_c = sub * box/nc is exactly the margin),
    so every min-image neighbor pair is a direct pair on the extended
    (nc + 2 sub)^3 grid.  R_c must fit strictly inside half the box
    (distinct images / complement support must not wrap onto itself):
    nc >= 2 sub + 1."""
    nc, sub = _cell_grid_params(ng, int(cutoff_cells))
    if nc < 2 * sub + 1:
        raise ValueError(
            f"periodic P3M needs R_c < box/2 (cell grid nc >= "
            f"{2 * sub + 1}); got nc={nc} from grid={ng}, "
            f"cutoff_cells={cutoff_cells} — raise grid or lower "
            "cutoff_cells")
    return nc, sub


def _periodic_geom(ng: int, cutoff_cells: int, box: float):
    """Shared periodic binning geometry: ``(nc, sub, rc, nc_tot,
    lo_cell, span_tot)``.  ONE definition used by the solver, the
    sharded solver and the plan/overflow diagnostics — they must bin
    onto the SAME ghost-extended grid or measured plans desync from the
    solve."""
    f32 = jnp.float32
    nc, sub = _periodic_cells(ng, cutoff_cells)
    cs = box / nc
    rc = f32(sub * cs)
    nc_tot = nc + 2 * sub
    lo_cell = jnp.full((3, 1), f32(-sub * cs))
    span_tot = jnp.full((3, 1), f32(box + 2 * sub * cs))
    return nc, sub, rc, nc_tot, lo_cell, span_tot


def _periodic_ghost_bin(src_w, mass, box, rc, nc_tot, lo_cell, span_tot,
                        gcap: int, tgt_w=None):
    """Ghost-image + bin-candidate assembly on the ghost-extended grid
    (the block every periodic binning site shares).  Slot layout is
    ``[sources | ghosts(gcap)]``, or ``[sources | ghosts(gcap) |
    targets]`` when distinct targets join as massless receivers.
    Returns (pos_bin, m_bin, cid, n_ghost traced scalar)."""
    f32 = jnp.float32
    gpos, gmass, n_ghost = _ghost_images(src_w, mass, box, rc, gcap)
    if tgt_w is None:
        pos_bin = jnp.concatenate([src_w, gpos], axis=1)
        m_bin = jnp.concatenate([mass, gmass])
        inc = m_bin > 0
    else:
        pos_bin = jnp.concatenate([src_w, gpos, tgt_w], axis=1)
        m_bin = jnp.concatenate(
            [mass, gmass, jnp.zeros((tgt_w.shape[1],), f32)])
        inc = jnp.concatenate(
            [mass > 0, gmass > 0, jnp.ones((tgt_w.shape[1],), bool)])
    cid = _bin_cids(pos_bin, lo_cell, span_tot, nc_tot, inc)
    return pos_bin, m_bin, cid, n_ghost


def _periodic_p3m_force_grids(rho_hat, rho_over_hat_fn, comb, comp,
                              has_over):
    """Periodic analog of _p3m_force_grids: (acc_grids, comp_grids)
    under the overflow cond.  Contract (same as the open solver):
    unbinned sources' full force rides the combined spectrum minus
    their complement (rho C - roh S), and binned-but-overflow-adjacent
    targets pick the complement field back up via (roh - rho) S.
    ``rho_over_hat_fn`` is lazy so the overflow FFT only traces inside
    the taken branch (the sharded caller's psum'd deposit stays outside
    the cond; only its fftn is deferred)."""

    def _over(_):
        roh = rho_over_hat_fn()
        g = jnp.stack([jnp.fft.ifftn(rho_hat * c - roh * s).real
                       for c, s in zip(comb, comp)])
        cg = jnp.stack([jnp.fft.ifftn((roh - rho_hat) * s).real
                        for s in comp])
        return g, cg

    def _plain(_):
        g = jnp.stack([jnp.fft.ifftn(rho_hat * c).real for c in comb])
        return g, jnp.zeros_like(g)

    return jax.lax.cond(has_over, _over, _plain, operand=None)


def _periodic_p3m_spectra(box, ng: int, rc2):
    """(combined long-range C_j, complement S_j) force spectra for
    periodic P3M, each a 3-tuple of (ng, ng, ng) complex64.

    The complement kernel s_j(d) = d_j (1 - S(r^2/R_c^2)) u^3 is
    sampled with MINIMUM-IMAGE displacements — its support R_c < L/2
    puts exactly one image at every grid point, so the single sampled
    kernel IS the periodic complement — and transformed (3 fftns of
    ng^3: 1/16 the transform volume of the open P3M kernel build).
    The long-range part combines it with the closed-form full
    spectrum:  C_j = (i k_j phi_hat + s_hat_j) W,  S_j = s_hat_j W,
    with phi_hat the periodic Plummer potential spectrum
    (_periodic_phi_spectrum: a_full = ifftn(rho_hat i k phi_hat)) and
    W the CIC-deconvolution sharpening (_cic_sharpen on the ng grid —
    safe here, unlike plain periodic pm at ng=32, because the tapered
    kernel is band-limited on the R_c >> h scale; measured in
    tests/test_pm.py vs the direct k-space sum).  Signs: the open
    solver computes a = -ifftn(rho_hat f_hat) for a sampled kernel, so
    a_lr = -(rho * (f - s)) = ifftn(rho_hat (i k phi_hat + s_hat)) and
    the complement field of mass x is -ifftn(rho_x_hat S_j)."""
    f32 = jnp.float32
    idx = jnp.arange(ng)
    # min-image displacement per axis; the ambiguous ng/2 point (+-L/2)
    # has zero complement weight either way (R_c < L/2).
    d1 = (jnp.where(idx <= ng // 2, idx, idx - ng).astype(f32)
          * (f32(box) / f32(ng)))
    rx = d1[:, None, None]
    ry = d1[None, :, None]
    rz = d1[None, None, :]
    r2 = rx * rx + ry * ry + rz * rz
    u = jax.lax.rsqrt(r2 + jnp.float32(SOFTENING_SQUARED))
    w1 = (jnp.float32(1.0) - _taper(r2 / rc2)) * (u * u * u)
    phi = _periodic_phi_spectrum(box, ng)
    k1d = _periodic_kvecs(box, ng)
    kaxes = (k1d[:, None, None], k1d[None, :, None], k1d[None, None, :])
    W = _cic_sharpen(ng, m=ng)
    comb, comp = [], []
    for dj, kc in zip((rx, ry, rz), kaxes):
        s_hat = jnp.fft.fftn(dj * w1)
        comp.append(s_hat * W)
        comb.append((1j * kc * phi + s_hat) * W)
    return tuple(comb), tuple(comp)


@functools.partial(jax.jit, static_argnums=(2, 3))
def periodic_potential_energy(pos, mass, box: float,
                              grid: int = DEFAULT_GRID) -> jax.Array:
    """Background-subtracted periodic potential energy

    Jitted (box/grid static): the engine's total_energy calls this
    from host code, and an un-jitted mesh solve would dispatch 100+
    individual ops.

    PE = -(G/2) sum_i m_i Phi(x_i), with Phi the mesh-solved periodic
    potential (k=0 dropped — the finite comoving-box convention; the
    raw image sum of the softened 1/r potential DIVERGES, so the
    open-boundary pairwise potential_energy is meaningless here).
    Mesh quality (CIC-limited), which is what a drift diagnostic needs
    — it compares E(t) against E(0) under the same definition.  The
    CIC self-cloud term is included (near-constant, drift-neutral),
    matching the open PE's kept self term."""
    ng = int(grid)
    f32 = jnp.float32
    pos = pos.astype(f32)
    mass = mass.astype(f32)
    rho = _deposit_periodic(pos, mass, box, ng)
    phi = jnp.fft.ifftn(
        jnp.fft.fftn(rho) * _periodic_phi_spectrum(box, ng)).real
    vals = _gather_periodic(phi[None].astype(f32), pos, box, ng)[0]
    return (-0.5 * f32(G_NEWTON)) * jnp.sum(mass * vals)


def _robust_box(pos, mass):
    """Robust mesh box (lo (3,1), hi (3,1)) for the MASSIVE particles.

    Two failure modes shape this:

    * Zero-mass padding sits on a far diagonal (state.pad_state) — it is
      excluded entirely, or it would dilate the grid spacing by orders of
      magnitude and destroy the solve's resolution.
    * Heavy-tailed distributions (e.g. Plummer) put a few massive
      particles at many core-radii; an exact bounding box over them
      under-resolves the core just as badly (measured: 0.96 rel force
      error on Plummer ICs with an exact box).  The box is therefore the
      inner-99% percentile span per axis, expanded by a quarter-span on
      each side and clipped to the exact extent: for compact
      distributions it IS the exact bounding box (nothing changes),
      while tail particles fall outside and are handled analytically by
      the monopole far field (see accelerations_between).  (Round 2
      expanded by a WHOLE span; the quarter-span box resolves the
      Plummer core ~2x finer — measured: pm ng=64 error 0.38 -> 0.24 —
      and is what makes the P3M cell list's occupancy tractable, while
      still dwarfing the subsample quantile noise.)
    """
    real = mass[None, :] > 0
    big = jnp.float32(3e38)
    lo_exact = jnp.min(jnp.where(real, pos, big), axis=1, keepdims=True)
    hi_exact = jnp.max(jnp.where(real, pos, -big), axis=1, keepdims=True)
    # Percentiles on a strided subsample: a 0.5% quantile needs only
    # ~64k samples, and full-N sorts cost ~11 ms/step at N=1M (measured).
    # The box is expanded by a quarter span and clipped to the exact
    # extent, so subsampling noise in the quantile estimate is harmless.
    stride = max(1, pos.shape[1] // 65536)
    nanpos = jnp.where(real[:, ::stride], pos[:, ::stride], jnp.nan)
    q = jnp.nanpercentile(nanpos, jnp.asarray([0.5, 99.5]), axis=1)  # (2,3)
    return _box_from_stats(lo_exact, hi_exact, q[0][:, None], q[1][:, None])


def _box_from_stats(lo_exact, hi_exact, q_lo, q_hi):
    """The robust-box formula from its four per-axis statistics:
    quarter-span-expanded quantile box, clipped to the exact extent."""
    span_q = jnp.float32(0.25) * (q_hi - q_lo)
    lo = jnp.maximum(lo_exact, q_lo - span_q)
    hi = jnp.minimum(hi_exact, q_hi + span_q)
    return lo, jnp.maximum(hi, lo + jnp.float32(1e-6))


def _robust_box_sharded(pos_l, mass_l, axis):
    """_robust_box for a particle-sharded state inside shard_map: exact
    extents via pmin/pmax, quantiles on an all-gathered strided
    subsample (bounded at ~64k samples TOTAL across shards — the only
    position traffic the sharded mesh solve has)."""
    from jax import lax

    real = mass_l[None, :] > 0
    big = jnp.float32(3e38)
    lo_exact = lax.pmin(
        jnp.min(jnp.where(real, pos_l, big), axis=1, keepdims=True), axis
    )
    hi_exact = lax.pmax(
        jnp.max(jnp.where(real, pos_l, -big), axis=1, keepdims=True), axis
    )
    k = lax.axis_size(axis)
    stride = max(1, (k * pos_l.shape[1]) // 65536)
    nanpos = jnp.where(real[:, ::stride], pos_l[:, ::stride], jnp.nan)
    allsub = lax.all_gather(nanpos, axis, axis=1, tiled=True)
    q = jnp.nanpercentile(allsub, jnp.asarray([0.5, 99.5]), axis=1)
    return _box_from_stats(lo_exact, hi_exact, q[0][:, None], q[1][:, None])


def _inside(pos, lo, hi):
    """(N,) f32 mask: 1 where the particle is inside the mesh box."""
    ok = jnp.all((pos >= lo) & (pos <= hi), axis=0)
    return ok.astype(jnp.float32)


def _cell_grid_params(ng: int, cutoff_cells: int) -> tuple[int, int]:
    """Cell-list geometry for the short-range pass: ``nc`` cells per axis
    and the neighbor reach ``sub`` (candidates come from the
    (2*sub+1)^3 neighborhood).  R_c = sub * cell_side ~ cutoff_cells
    mesh spacings; containment (every pair within R_c inside the
    neighborhood) holds by construction.  Coarse meshes get sub=2 —
    half-R_c cells with a +-2 reach — which checks a (5/2)^3 ~ 2x
    SMALLER candidate volume than 27 full cells AND halves the
    per-cell occupancy skew.  nc is capped so the (nc^3, cap) index
    table stays modest."""
    sub = 1 if ng // int(cutoff_cells) >= 24 else 2
    nc = max(2, (sub * ng) // int(cutoff_cells))
    return min(nc, 40), sub


def _auto_capacity(n_src: int, n_cells: int) -> int:
    """Static per-cell slot count fallback when the caller gives none:
    ~8x the average occupancy, power-of-two, in [64, 512].  DENSITY-BLIND
    — heavy-tailed cores overflow it; callers with concrete data (the
    simulation engine at block-build time, diagnostics) should use
    suggest_capacity instead.  Overflow degrades gracefully: overflowed
    particles keep a mesh-quality FULL force via the complement-kernel
    deposit (see accelerations_between), they just lose short-range
    exactness — see cell_overflow_fraction for the diagnostic."""
    avg = max(1, n_src // max(n_cells, 1))
    cap = 64
    while cap < 8 * avg and cap < 512:
        cap *= 2
    return cap


def _cell_coords(pos, lo_box, inv_c, nc):
    """Integer cell coordinates (3, N) on the nc^3 cell grid over the
    mesh box (positions clipped into the grid; out-of-box masking is the
    caller's job via the `inside` masks)."""
    g = jnp.clip((pos - lo_box) * inv_c, 0.0, float(nc) - 1.0)
    return jnp.floor(g).astype(jnp.int32)


def _neighbor_offsets(sub: int):
    r = range(-sub, sub + 1)
    return tuple((ox, oy, oz) for ox in r for oy in r for oz in r)


# Slots per slab — the dense pair-block edge.  Slabs are the unit of
# all short-range data movement (contiguous SLAB*4-byte rows) and of
# the (SLAB x SLAB) dense pair blocks the sweep executes.
SLAB = 64

# Pair-symmetric short-range sweep: each unordered slab pair once
# (s >= t), reaction added per entry — about half the entries for ~25%
# extra per-entry work.  A module knob, not a per-call option; tests
# flip it to check both worklists against each other.
SR_SYMMETRIC = True


def _sr_pack(cid, pos, mass, n_cells: int, cap: int, s_max: int):
    """Packed slab tables for the short-range sweep: ``SLAB`` CONSECUTIVE
    cid-sorted particles per slab, cell boundaries ignored.

    The compact support of the short-range factor makes this exact: a
    pair beyond R_c has weight (1 - S) == 0.0 EXACTLY (see _taper), so
    the sweep may visit any SUPERSET of the within-R_c pairs.  Packing
    by sorted position instead of by cell keeps every slab 100% full —
    the per-cell layout this replaced left slabs ~ occupancy/SLAB full
    (3% on uniform ICs at 2 particles/cell) and paid ~30x the pair work
    in padding (measured: 178 ms/step vs the exact kernel's 13 at
    N=65536 uniform).

    ``cid`` is (Ns,) int32 in [0, n_cells]; the value ``n_cells`` marks
    EXCLUDED particles (out-of-box, zero-mass — and, in the *between*
    case, nothing: massless target entries are included so they can
    RECEIVE forces without exerting any).  Capacity-overflowed
    particles (per-cell rank >= cap) are excluded from the tables like
    round 2 — they keep mesh-quality full forces via the complement
    kernel — which bounds the core's quadratic pair work.

    Returns ``(ptab (3, (s_max+1)*SLAB), mtab ((s_max+1)*SLAB,),
    slab_lo (s_max,), slab_hi (s_max,), pslot (Ns,), binned (Ns,))``:
    slab ``s_max`` is the zero-mass sentinel, ``slab_lo/hi`` are each
    real slab's first/last cell id (``n_cells`` for empty tail slots,
    keeping both arrays sorted for the range searches), and ``binned``
    is False for excluded/overflowed particles — the caller serves
    those at mesh quality."""
    i32 = jnp.int32
    ns = cid.shape[0]
    order = jnp.argsort(cid).astype(i32)
    sc = cid[order]
    cells = jnp.arange(n_cells, dtype=i32)
    starts = jnp.searchsorted(sc, cells, side="left").astype(i32)
    rank = jnp.arange(ns, dtype=i32) - starts[jnp.clip(sc, 0, n_cells - 1)]
    valid = (sc < n_cells) & (rank < cap)
    # Pack: binned particles first in cid order, the rest to the tail.
    # This is a STABLE PARTITION of an already-sorted key (valid keys
    # keep ascending cid order, invalid ones collapse to the n_cells
    # sentinel), so the former stable argsort — a second full N-element
    # sort — reduces to an exclusive count + scatter (same result,
    # element-for-element: valid entries in order first, sentinel
    # entries in original order after).
    #
    # Formulation chosen by an A/B race (scripts/exp_pack_ab.py; not
    # yet re-measured on a GPU).  The pord scatter stays a scatter: replacing it with searchsorted
    # gathers (the _ghost_images trick) regressed the full p3m step
    # ~2x (jnp.searchsorted's scan lowering — log2(N) SEQUENTIAL
    # dynamic-slice rounds over the full array — loses to XLA's one
    # sort when the query set is as big as the data).  The TABLE
    # builds, by contrast, are gathers (slot k < n_bin is packed
    # position k verbatim — the old .at[:, slot].set was an identity
    # scatter), binned derives from pslot instead of a second scatter,
    # and pslot declares unique indices: full p3m step 663 -> 617
    # ms/step at Plummer 1M (pack stage 111 -> 67), 397 -> 371 at
    # uniform 1M, neutral at 65k.
    vi = valid.astype(i32)
    nv = jnp.cumsum(vi) - vi  # valid entries strictly before i
    n_bin = jnp.sum(vi)
    ppos_all = jnp.arange(ns, dtype=i32)
    dest = jnp.where(valid, nv, n_bin + (ppos_all - nv))
    pord = jnp.zeros((ns,), i32).at[dest].set(ppos_all)
    perm = order[pord]  # original particle index per packed position
    pc = jnp.where(valid, sc, n_cells)[pord]  # packed cids, sentinel tail
    nslots = (s_max + 1) * SLAB
    ppos = jnp.arange(ns, dtype=i32)
    ok = (ppos < n_bin) & (ppos < s_max * SLAB)
    slot = jnp.where(ok, ppos, nslots - 1)  # tail -> sentinel slot
    f32 = jnp.float32
    kk = jnp.arange(nslots, dtype=i32)
    okk = (kk < n_bin) & (kk < s_max * SLAB)
    ksrc = jnp.minimum(kk, ns - 1)
    ptab = jnp.where(okk[None, :], pos[:, perm[ksrc]], f32(0))
    mtab = jnp.where(okk, mass[perm[ksrc]], f32(0))
    pslot = jnp.zeros((ns,), i32).at[perm].set(slot, unique_indices=True)
    binned = pslot != (nslots - 1)  # slot==sentinel iff not ok
    # Per-slab cid bounds (real slabs only; empty tail slots pinned to
    # n_cells so slab_lo AND slab_hi stay sorted for searchsorted).
    sidx = jnp.arange(s_max, dtype=i32) * SLAB
    has = sidx < n_bin
    last = jnp.clip(jnp.minimum(sidx + (SLAB - 1), n_bin - 1), 0, ns - 1)
    slab_lo = jnp.where(has, pc[jnp.minimum(sidx, ns - 1)], n_cells)
    slab_hi = jnp.where(has, pc[last], n_cells)
    return ptab, mtab, slab_lo, slab_hi, pslot, binned


def _sr_ranges(slab_lo, slab_hi, nc: int, sub: int, e_max: int,
               symmetric: bool = False):
    """Static-shape worklist of (target-slab, source-slab) dense pair
    blocks from PACKED slab cid bounds.

    ``symmetric=True`` keeps only entries with s >= t (each unordered
    slab pair once, plus the diagonal): every within-cutoff pair is
    emitted in BOTH directions by the window construction — window(t)
    covers reach(t), reach is symmetric, and the running-max dedup only
    re-windows same-t overlaps — so clipping each interval at t drops
    exactly the mirror copies (and some zero-weight padding).  The
    symmetric sweeps add the reaction term per entry.

    For target slab t covering cells [lo_t, hi_t] and each of the
    (2*sub+1)^2 (ox, oy) stencil rows, the candidate sources are the
    slabs overlapping the cid window [lo_t + off - sub, hi_t + off + sub]
    (the z offsets merge into the +-sub because cid is z-minor) — a
    CONTIGUOUS slab interval found by two searchsorteds.  Windows of
    successive rows can overlap when a slab spans many cells; a running
    max over the (off-ascending) rows clips each interval past its
    predecessors, so no (t, s) pair is ever emitted twice (pair forces
    would double).  Windows may also cover out-of-stencil cells (z
    wrap-around into a neighboring column, sparse-slab cid gaps): those
    extra pairs are beyond R_c and contribute EXACTLY zero (taper
    support), costing only the wasted block.

    Entries are laid out t-major by an exclusive cumsum (deterministic,
    so every shard of a replicated build agrees); entries beyond
    ``e_max`` are DROPPED — size from ``suggest_sr_plan``'s measured
    count, or the guaranteed (dedup <= one disjoint interval set per
    target => <= s_max entries per target) bound s_max^2.

    Returns ``(wl_t (e_max,), wl_s (e_max,), n_entries)`` with
    ``n_entries`` a traced scalar — the sweeps' entry bound, so the
    padded worklist tail costs (almost) nothing at runtime.  Entries
    are laid out t-major, so each target slab's entries form one
    contiguous run."""
    i32 = jnp.int32
    s_max = slab_lo.shape[0]
    n_cells = nc * nc * nc
    offs = sorted((ox * nc + oy) * nc for ox in range(-sub, sub + 1)
                  for oy in range(-sub, sub + 1))
    off_arr = jnp.asarray(offs, i32)[None, :]  # (1, R)
    n_rows = off_arr.shape[1]
    has = slab_lo < n_cells
    lo_w = slab_lo[:, None] + (off_arr - sub)  # (S, R) window bounds
    # Clamp the window top to the last REAL cell id: empty padding slabs
    # are pinned at the n_cells sentinel, so an unclamped hi_w >= n_cells
    # would sweep them all in — making n_e grow with the table's slab
    # padding and letting phantom zero-weight entries overflow a
    # measured ``suggest_sr_plan`` e_max (dropping real tail entries).
    hi_w = jnp.minimum(slab_hi[:, None] + (off_arr + sub), n_cells - 1)
    # Interval bounds by counting-LUT instead of searchsorted: the
    # queries live on the small integer domain [0, n_cells], so
    # searchsorted(A, c, left) = #\{a in A : a < c\} is a scatter-count
    # of A followed by a cumsum, then one GATHER per query — one memory
    # pass instead of log2(S) binary-search passes (bit-identical).  Padding slabs sit at the n_cells sentinel ->
    # LUT slot n_cells+1, counted only by queries clipped there, exactly
    # like searchsorted's out-of-range answer.
    def count_lt(vals, queries):
        cnt = jnp.zeros((n_cells + 2,), i32).at[
            jnp.clip(vals + 1, 0, n_cells + 1)].add(1, mode="drop")
        return jnp.cumsum(cnt)[jnp.clip(queries, 0, n_cells + 1)]

    s0 = count_lt(slab_hi, lo_w.reshape(-1)).reshape(s_max, n_rows)
    s1 = count_lt(slab_lo, hi_w.reshape(-1) + 1).reshape(s_max, n_rows)
    run = jnp.concatenate(
        [jnp.zeros((s_max, 1), i32),
         jax.lax.cummax(s1, axis=1)[:, :-1]], axis=1)
    s0 = jnp.maximum(s0, run)
    if symmetric:
        s0 = jnp.maximum(s0, jnp.arange(s_max, dtype=i32)[:, None])
    s1 = jnp.maximum(s1, s0)
    cnt = jnp.where(has[:, None], s1 - s0, 0)  # (S, R)
    flat = cnt.reshape(-1)
    cum = jnp.cumsum(flat)
    n_e = cum[-1]
    base = (cum - flat)
    e_idx = jnp.arange(e_max, dtype=i32)
    # Expand bucket counts to a per-entry bucket id.  This used to be
    # searchsorted(cum, e_idx, side="right") — log2(S*R) binary-search
    # passes, each an e_max-wide gather, which dominated the whole p3m
    # step in an earlier ablation.  Both arrays
    # are sorted, so the expansion is one scatter of each nonempty
    # bucket's id at its segment start followed by a running max: two
    # nonempty buckets can never share a start (base is strictly
    # increasing on nonempty buckets), empty buckets are dropped, and
    # entries before the first segment start need id 0 = the cummax
    # seed.  Positions >= n_e may disagree with searchsorted's
    # out-of-range answer, but they are masked to the sentinel below
    # either way.
    nonempty = flat > 0
    start_pos = jnp.where(nonempty & (base < e_max), base, e_max)
    buckets = jnp.arange(flat.shape[0], dtype=i32)
    # Target slab per entry: t = bucket // n_rows is MONOTONE in bucket,
    # so scattering it at each nonempty bucket's segment start and
    # running-maxing carries it across the segment (empty buckets drop;
    # entries before the first start need 0 = the cummax seed, and
    # position 0 is always a start when n_e > 0 because the first
    # nonempty bucket has base 0).
    t_marks = jnp.zeros((e_max,), i32).at[start_pos].max(
        buckets // n_rows, mode="drop")
    t_fill = jax.lax.cummax(t_marks)
    # Source slab per entry:
    #   wl_s = s0[bucket] + (position - base[bucket]) = v[bucket] + position
    # with v = s0 - base per-segment constant but NOT monotone, so the
    # max trick above does not apply.  Instead scatter each segment's
    # DELTA of v (vs the previous nonempty bucket) at its start and
    # integrate with a cumsum — it telescopes to v inside every segment.
    # The previous nonempty bucket's v comes from a rank compaction:
    # (S*R)-sized gathers, ~10x smaller than the e_max-sized s0[j_c]
    # gather this replaces.
    v = s0.reshape(-1) - base
    rank = jnp.cumsum(nonempty.astype(i32))  # inclusive rank
    order = jnp.where(nonempty, rank - 1, flat.shape[0])
    v_by_order = jnp.zeros((flat.shape[0],), i32).at[order].set(
        v, mode="drop")
    prev_v = jnp.where(rank >= 2, v_by_order[jnp.maximum(rank - 2, 0)], 0)
    delta = jnp.where(nonempty, v - prev_v, 0)
    v_marks = jnp.zeros((e_max,), i32).at[start_pos].add(delta, mode="drop")
    v_fill = jnp.cumsum(v_marks)
    ok = e_idx < n_e
    wl_t = jnp.where(ok, t_fill, s_max).astype(i32)
    wl_s = jnp.where(ok, v_fill + e_idx, s_max).astype(i32)
    return wl_t, wl_s, n_e


def _sr_sizing(n_cap: int, n_bin: int, n_cells: int, capacity: int,
               sr_slabs: int, sr_entries: int):
    """Resolve the static cell capacity and (s_max, e_max) plan bounds —
    the measured ``suggest_sr_plan`` values when given, the guaranteed
    defaults otherwise.  ``n_cap`` sizes the per-cell capacity (source
    count), ``n_bin`` the slab tables (sources + any massless target
    copies)."""
    cap = int(capacity) or _auto_capacity(n_cap, n_cells)
    s_max, e_max = int(sr_slabs), int(sr_entries)
    if not (s_max and e_max):
        ds, de = _default_sr_plan(n_bin)
        s_max, e_max = s_max or ds, e_max or de
    return cap, s_max, e_max


def _sr_rc2(span, nc: int, sub: int):
    """Squared cutoff radius: ``sub`` cell widths of the SHORTEST box
    axis (the taper must fit inside the stencil in every direction)."""
    rc = jnp.float32(sub) * jnp.min(span[:, 0]) / jnp.float32(nc)
    return rc * rc


def _bin_cids(pos, lo_box, span, nc: int, inc):
    """Cell ids of the bin candidates; everything excluded by the
    boolean ``inc`` (out-of-box, zero-mass padding) gets the n_cells
    sentinel so _sr_pack sorts it past every real slab."""
    co = _cell_coords(pos, lo_box, jnp.float32(nc) / span, nc)
    cid = (co[0] * nc + co[1]) * nc + co[2]
    return jnp.where(inc, cid, nc * nc * nc)


def _outlier_moments(pos, mass, m_in, lo_box, hi_box, reduce):
    """Monopole moments for the out-of-box handling shared by the
    single-device and sharded solvers: total in-box (M_in, com_in) plus
    one outlier monopole PER DIRECTION OCTANT around the box center — a
    single collective monopole would misplace outliers that straddle
    the box (two heavy bodies on opposite sides average to a phantom
    central mass); per-octant groups keep each far AND on its own side,
    and a lone outlier's self-force is exactly zero (d = 0 under
    softening).  ``reduce`` is identity locally, lax.psum sharded."""
    f32 = jnp.float32
    tiny = f32(1e-30)
    M_in = reduce(jnp.sum(m_in))
    com_in = reduce(
        (pos * m_in).sum(axis=1, keepdims=True)) / jnp.maximum(M_in, tiny)
    m_out = mass - m_in
    ctr = 0.5 * (lo_box + hi_box)  # (3, 1)
    side = (pos > ctr).astype(jnp.int32)
    oct_id = side[0] * 4 + side[1] * 2 + side[2]
    octs = []
    for k in range(8):
        m_k = m_out * (oct_id == k).astype(f32)
        M_k = reduce(jnp.sum(m_k))
        S_k = reduce((pos * m_k).sum(axis=1, keepdims=True))
        octs.append((M_k, S_k / jnp.maximum(M_k, tiny)))
    return M_in, com_in, octs


def _pm_force_grids(rho_hat, h, ng: int, spectra=None):
    """Plain-PM acceleration grids: a(c) = -(rho * f)(c) per component
    (antisymmetric kernel), via the full-complex transforms.
    ``spectra`` short-circuits the per-step kernel sampling + 3 forward
    fftns with block-frozen values (make_mesh_env)."""
    kx, ky, kz = spectra or _force_kernel_spectra(h, ng)
    return jnp.stack([
        -jnp.fft.ifftn(rho_hat * k).real[:ng, :ng, :ng]
        for k in (kx, ky, kz)])


def _p3m_force_grids(rho_hat, rho_over_hat_fn, h, ng: int, rc2, has_over,
                     spectra=None):
    """(acc_grids, comp_grids) for the P3M split, under the overflow
    lax.cond: everyone gets the tapered long-range kernel of the full
    in-box mass, overflowed sources additionally deposit through the
    complement (short-range) kernel, and ``comp_grids`` carries the
    binned mass's complement field for overflowed TARGETS — mesh-quality
    full forces on BOTH sides of every overflow pair.  With no overflow
    the cond skips the seven extra (2ng)^3 transforms entirely.

    ``rho_over_hat_fn`` produces the overflow-mass spectrum INSIDE the
    cond (the single-device caller defers its deposit+fft there); a
    caller with collectives must run them OUTSIDE the cond and close
    over the result (sharded_accelerations psums the overflow deposit
    unconditionally).  ``spectra`` short-circuits the per-step kernel
    sampling + 6 forward fftns with block-frozen values
    (make_mesh_env)."""
    (kx, ky, kz), (sx, sy, sz) = spectra or _p3m_spectra(h, ng, rc2)

    def grids(specs):
        return jnp.stack([
            -jnp.fft.ifftn(s).real[:ng, :ng, :ng] for s in specs])

    def _over(_):
        roh = rho_over_hat_fn()
        g = grids((rho_hat * kx + roh * sx,
                   rho_hat * ky + roh * sy,
                   rho_hat * kz + roh * sz))
        comp = grids(((rho_hat - roh) * sx,
                      (rho_hat - roh) * sy,
                      (rho_hat - roh) * sz))
        return g, comp

    def _plain(_):
        g = grids((rho_hat * kx, rho_hat * ky, rho_hat * kz))
        return g, jnp.zeros_like(g)

    return jax.lax.cond(has_over, _over, _plain, operand=None)


def sr_pack_inputs(pos, mass, grid: int = DEFAULT_GRID,
                   cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
                   capacity: int = 0, sr_slabs: int = 0,
                   sr_entries: int = 0, symmetric: bool = False) -> dict:
    """Build the short-range packed tables + worklist EXACTLY as
    ``accelerations_between``'s same-set branch does — the single
    packing recipe, exposed so tests and experiment scripts compare the
    sweeps against the configuration the production solver actually
    runs (hand-maintained replicas drift).  Returns a dict with
    ``ptab, mtab, wl_t, wl_s, n_e, e_max, rc2``."""
    f32 = jnp.float32
    pos = pos.astype(f32)
    mass = mass.astype(f32)
    ng = int(grid)
    nc, sub = _cell_grid_params(ng, int(cutoff_cells))
    n_cells = nc * nc * nc
    ns = pos.shape[1]
    lo_box, hi_box = _robust_box(pos, mass)
    span = hi_box - lo_box
    inc = (mass * _inside(pos, lo_box, hi_box)) > 0
    cap, s_max, e_max = _sr_sizing(ns, ns, n_cells, capacity,
                                   sr_slabs, sr_entries)
    cid = _bin_cids(pos, lo_box, span, nc, inc)
    ptab, mtab, slab_lo, slab_hi, _, _ = _sr_pack(
        cid, pos, mass, n_cells, cap, s_max)
    wl_t, wl_s, n_e = _sr_ranges(slab_lo, slab_hi, nc, sub, e_max,
                                 symmetric=symmetric)
    return dict(ptab=ptab, mtab=mtab, wl_t=wl_t, wl_s=wl_s, n_e=n_e,
                e_max=e_max, rc2=_sr_rc2(span, nc, sub))


def _sr_sweep(ptab, mtab, wl_t, wl_s, n_entries, rc2, chunk: int = 512,
              chunk_lo=0, chunk_cap: int = 0,
              static_bound: bool = False, symmetric: bool = False):
    """Execute the worklist as dense (SLAB x SLAB) pair blocks, ``chunk``
    entries per loop step, accumulating the short-range residual

        a_t += sum_s m_s (r_s - r_t) (|r|^2+eps^2)^{-3/2} (1 - S(r^2/rc2))

    into a per-slot table (3, (s_max+1)*SLAB).  Self term: dx = 0 makes
    it exactly zero under softening (never mask the diagonal —
    ver0/GSimulation.cpp:130-150 semantics).  All reads are whole-slab
    rows (contiguous SLAB-float lines), the pair math is dense broadcast
    work, and the accumulate is a row scatter-add; nothing indexes
    per particle.  The loop bound is TRACED (ceil(n_entries/chunk)) so
    the statically padded worklist tail is skipped at runtime — which
    makes the sweep forward-only, UNLESS ``static_bound=True``
    (the ``differentiable=True`` path) swaps in the static chunk count:
    reverse AD then crosses the loop, at the cost of also sweeping the
    zero-contribution tail (do NOT combine with a traced ``chunk_lo``:
    the min() below re-traces the bound and AD fails again — the
    sharded caller never passes static_bound).  With ``chunk_cap > 0``
    only chunks
    [chunk_lo, chunk_lo + chunk_cap) are swept — the sharded path
    splits entry chunks across shards and psums the slot table.
    ``symmetric=True`` executes the s >= t worklist (see _sr_ranges)
    and adds the per-entry reaction."""
    f32 = jnp.float32
    eps2 = f32(SOFTENING_SQUARED)
    e_max = wl_t.shape[0]
    w = int(chunk)
    pad = (-e_max) % w
    s_max = ptab.shape[1] // SLAB - 1
    if pad:
        ext = jnp.full((pad,), s_max, wl_t.dtype)
        wl_t = jnp.concatenate([wl_t, ext])
        wl_s = jnp.concatenate([wl_s, ext])
    ptab_r = ptab.reshape(3, s_max + 1, SLAB)
    mtab_r = mtab.reshape(s_max + 1, SLAB)
    if static_bound:
        # Python-int loop bound: reverse-mode AD cannot cross a
        # traced-length fori_loop (it lowers to a while), but a static
        # bound lowers to scan.  The padded tail (sentinel entries,
        # zero-mass slab) contributes exactly zero to values AND
        # cotangents — its table slots are where()'d constants, not
        # views of real particles — so only forward-pass time is spent.
        n_act = (e_max + pad) // w
    else:
        n_act = (jnp.minimum(n_entries, e_max) + (w - 1)) // w
    hi = n_act if not chunk_cap else jnp.minimum(n_act,
                                                 chunk_lo + chunk_cap)

    def body(ci, atab):
        te = jax.lax.dynamic_slice(wl_t, (ci * w,), (w,))
        se = jax.lax.dynamic_slice(wl_s, (ci * w,), (w,))
        pt = ptab_r[:, te]  # (3, w, SLAB) — whole-slab rows
        ps = ptab_r[:, se]
        ms = mtab_r[se]  # (w, SLAB); sentinel slabs are zero-mass
        d = ps[:, :, None, :] - pt[:, :, :, None]  # (3, w, SLAB, SLAB)
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        u = jax.lax.rsqrt(r2 + eps2)
        wgt = ms[:, None, :] * (f32(1.0) - _taper(r2 / rc2)) * (u * u * u)
        wd = wgt[None] * d
        atab = atab.at[:, te].add(jnp.sum(wd, axis=3))
        if symmetric:
            # Reaction on the SOURCE slab, weighted by the TARGET
            # masses (wgt carries the source mass; the reaction needs
            # m_t): recompute with m_t, negate, skip diagonal entries
            # (a (t,t) block already holds both directions).
            mt = mtab_r[te]
            wr = mt[:, :, None] * (f32(1.0) - _taper(r2 / rc2)) * (
                u * u * u)
            off = (se != te).astype(f32)[None, :, None]
            atab = atab.at[:, se].add(
                -jnp.sum(wr[None] * d, axis=2) * off)
        return atab

    atab = jnp.zeros((3, s_max + 1, SLAB), f32)
    atab = jax.lax.fori_loop(chunk_lo, hi, body, atab)
    return atab.reshape(3, (s_max + 1) * SLAB)


def _default_sr_plan(n_bin: int):
    """Static bounds when the caller provides no measured plan.

    ``s_max = ceil(n/SLAB) + 1`` is exact for packed slabs.  The entry
    bound uses the dedup invariant (each target's source intervals are
    disjoint in [0, s_max) => <= s_max entries per target): s_max^2 is
    guaranteed-sufficient, capped at 2^22 to bound worklist memory —
    the cap binds only above N ~ 131k, where real runs come through the
    engine's measured suggest_sr_plan (and a capped worklist degrades
    gracefully: dropped tail entries lose pairs, never corrupt)."""
    s_max = n_bin // SLAB + 1 + (1 if n_bin % SLAB else 0)
    return s_max, min(s_max * s_max, 1 << 22)


def _monopole(pos_tgt, m_tot, com):
    """Softened point-mass force field of (m_tot, com) at the targets
    (3, N); the analytic far-field for particles outside the mesh box."""
    d = com - pos_tgt
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + jnp.float32(
        SOFTENING_SQUARED)
    u = jax.lax.rsqrt(r2)
    return m_tot * d * (u * u * u)


def _periodic_between(pos_tgt, pos_src, mass_src, ng: int, box: float,
                      spectra=None):
    """Periodic-box mesh accelerations of targets due to sources:
    wrapped CIC deposit -> ng^3 FFT -> spectral multiply by the
    closed-form periodic Plummer kernel -> wrapped CIC gather.  See the
    "Periodic-box boundary mode" section above for the method and its
    measured accuracy.  Natively differentiable (the wrap is identity
    a.e.; the spectrum is a constant of the trace).  ``spectra``: the
    frozen (ikx phi, iky phi, ikz phi) force spectra from a periodic
    mesh_env (None = rebuild in-trace)."""
    rho = _deposit_periodic(pos_src, mass_src, box, ng)
    rho_hat = jnp.fft.fftn(rho)
    if spectra is not None:
        acc_grids = jnp.stack(
            [jnp.fft.ifftn(rho_hat * s).real for s in spectra])
    else:
        acc_grids = _pm_force_grids_periodic(rho_hat, box, ng)
    acc = _gather_periodic(acc_grids, pos_tgt, box, ng)
    return (acc * jnp.float32(G_NEWTON)).astype(jnp.float32)


def _periodic_p3m_between(pos_tgt, pos_src, mass_src, same_set: bool,
                          ng: int, box: float, cutoff_cells: int,
                          capacity: int, sr_slabs: int, sr_entries: int,
                          sr_ghosts: int, differentiable: bool,
                          spectra=None):
    """Periodic P3M: the periodic mesh long-range solve plus the exact
    short-range correction, via GHOST IMAGES.

    The decomposition is the open P3M's (f = f*S mesh + f*(1-S) exact;
    see _taper) with two periodic twists:

    * mesh: one ng^3 deposit/FFT against the combined closed-form +
      sampled-complement long-range spectra (_periodic_p3m_spectra) —
      no doubled grid, no robust box, no monopoles;
    * short-range: boundary-crossing min-image pairs become DIRECT
      pairs by augmenting the sources with <= 7 shifted images of each
      near-face particle (_ghost_images) on a cell grid extended by
      ``sub`` ghost cells per side (_periodic_cells) — after which the
      packed tables, worklist and sweep (symmetric or not,
      differentiable or not) apply UNCHANGED.

    Degradation contract: dropped ghosts (gcap overflow) and
    capacity-overflowed cells lose short-range exactness for the
    affected pairs; overflowed REAL sources/targets keep mesh-quality
    FULL forces via the complement field like the open solver.  A
    ghost whose parent binned but which itself overflowed does NOT
    activate the complement (it would double-count the parent's
    interior field) — its cross-boundary pairs get long-range-only
    forces.  Both caps come from suggest_sr_plan's measured counts in
    engine runs, where the common case is zero overflow."""
    f32 = jnp.float32
    nc, sub, rc, nc_tot, lo_cell, span_tot = _periodic_geom(
        ng, cutoff_cells, box)
    rc2 = rc * rc
    src_w = _wrap_box(pos_src, box)
    tgt_w = src_w if same_set else _wrap_box(pos_tgt, box)
    ns = pos_src.shape[1]
    gcap = int(sr_ghosts) or _default_ghost_cap(ns)
    # Distinct targets join as massless receivers (open-path rule).
    pos_bin, m_bin, cid, _ = _periodic_ghost_bin(
        src_w, mass_src, box, rc, nc_tot, lo_cell, span_tot, gcap,
        tgt_w=None if same_set else tgt_w)
    n_cells_tot = nc_tot ** 3
    cap, s_max, e_max = _sr_sizing(ns, pos_bin.shape[1], n_cells_tot,
                                   capacity, sr_slabs, sr_entries)
    ptab, mtab, slab_lo, slab_hi, pslot, binned_all = _sr_pack(
        cid, pos_bin, m_bin, n_cells_tot, cap, s_max)
    binned_src = binned_all[:ns]
    m_over = jnp.where(binned_src, f32(0), mass_src)
    if same_set:
        has_over = jnp.any(jnp.logical_and(
            jnp.logical_not(binned_src), mass_src > 0))
    else:
        has_over = jnp.any(jnp.logical_and(
            jnp.logical_not(binned_src), mass_src > 0)) | jnp.any(
                jnp.logical_not(binned_all[ns + gcap:]))
    rho_hat = jnp.fft.fftn(_deposit_periodic(src_w, mass_src, box, ng))
    # Frozen-env spectra when given (constants of the run — fixed box);
    # the in-trace rebuild costs 3 ng^3 fftns + ng^3 kernel sampling
    # per STEP otherwise.
    comb, comp = (spectra if spectra is not None
                  else _periodic_p3m_spectra(box, ng, rc2))
    acc_grids, comp_grids = _periodic_p3m_force_grids(
        rho_hat,
        lambda: jnp.fft.fftn(_deposit_periodic(src_w, m_over, box, ng)),
        comb, comp, has_over)
    acc = _gather_periodic(acc_grids, tgt_w, box, ng)
    sym = SR_SYMMETRIC
    wl_t, wl_s, n_e = _sr_ranges(slab_lo, slab_hi, nc_tot, sub, e_max,
                                 symmetric=sym)
    atab = _sr_sweep(ptab, mtab, wl_t, wl_s, n_e, rc2,
                     static_bound=differentiable, symmetric=sym)
    tgt_slot = pslot[:ns] if same_set else pslot[ns + gcap:]
    tgt_binned = binned_all[:ns] if same_set else binned_all[ns + gcap:]
    a_sr = atab[:, tgt_slot]
    a_comp = jax.lax.cond(
        has_over,
        lambda _: _gather_periodic(comp_grids, tgt_w, box, ng),
        lambda _: jnp.zeros((3, tgt_w.shape[1]), f32),
        operand=None)
    acc = acc + jnp.where(tgt_binned[None, :], a_sr, a_comp)
    return (acc * f32(G_NEWTON)).astype(f32)


def _check_boundary(boundary: str, box_size: float):
    """Validate the boundary-mode options (shared by the single-device
    and sharded entry points).  Returns True for periodic."""
    if boundary not in ("open", "periodic"):
        raise ValueError(
            f"unknown boundary {boundary!r}; options: 'open', 'periodic'")
    if boundary == "open":
        return False
    if not box_size or float(box_size) <= 0:
        raise ValueError(
            "boundary='periodic' needs box_size > 0 (the fixed cubic "
            "box edge; positions are wrapped into [0, box_size))")
    return True


def _check_mesh_env(mesh_env: dict, ng: int, cutoff_cells: int,
                    periodic: bool = False):
    """Validate a mesh_env against the consuming solver config and
    return its spectra.  STRUCTURAL checks only (tuple nesting + array
    shapes survive jit boundaries; Python tags would arrive as tracers
    when the env is built in its own executable, as the host-chunked
    per-step path does): a p3m env is ((kx,ky,kz),(sx,sy,sz)), a plain
    pm env (kx,ky,kz); every open-boundary spectrum is (2ng)^3, every
    periodic one ng^3 (which is also what tells the two apart).
    Shared by accelerations_between and sharded_accelerations so a
    grid-, solver- or boundary-mismatched env fails with THIS message
    on both paths instead of an opaque downstream shape/unpack
    error."""
    spectra = mesh_env["spectra"]
    env_is_p3m = isinstance(spectra[0], tuple)
    env_m = (spectra[0][0] if env_is_p3m else spectra[0]).shape[0]
    want_m = ng if periodic else 2 * ng
    if env_is_p3m != bool(cutoff_cells) or env_m != want_m:
        raise ValueError(
            "mesh_env was built for a different solver config "
            f"(env spectra {env_m}^3, p3m={env_is_p3m}; call has "
            f"grid={ng}, p3m={bool(cutoff_cells)}, "
            f"boundary={'periodic' if periodic else 'open'} -> "
            f"wants {want_m}^3)")
    return spectra


def accelerations_between(
    pos_tgt: jax.Array,
    pos_src: jax.Array,
    mass_src: jax.Array,
    grid: int = DEFAULT_GRID,
    cutoff_cells: int = 0,
    capacity: int = 0,
    sr_slabs: int = 0,
    sr_entries: int = 0,
    sr_ghosts: int = 0,
    differentiable: bool = False,
    boundary: str = "open",
    box_size: float = 0.0,
    mesh_env: dict | None = None,
    **_opts,
) -> jax.Array:
    """Mesh-solved accelerations of targets due to sources.

    pos_tgt (3, Nt), pos_src (3, Ns), mass_src (Ns,) -> (3, Nt) f32.
    The mesh covers the robust (inner-99%, 3x-expanded) box of the
    MASSIVE sources (zero-mass padding and heavy-tail outliers excluded
    — see _robust_box); the few particles outside it are handled
    analytically:

    * outlier SOURCES contribute their combined monopole (M_out,
      com_out) to every target — they are genuinely far, so the
      point-mass field is accurate;
    * outlier TARGETS receive the in-box sources' monopole (M_in,
      com_in) instead of a mesh gather.

    For compact distributions the box equals the exact bounding box and
    both monopole terms vanish — the solve is pure mesh.

    ``cutoff_cells > 0`` enables the P3M short-range correction: the
    force is split exactly into a tapered long-range part solved on the
    mesh and a compact-support residual (r < R_c ~ cutoff_cells grid
    spacings) summed exactly over slab-compact cell tables driven by a
    static worklist of dense (SLAB x SLAB) pair blocks (see _taper /
    _sr_tables / _sr_worklist / _sr_sweep).  This is what makes
    CLUSTERED distributions accurate — one-level PM mesh-smooths close
    pairs (Plummer: 0.18 rel force error at ng=128), while P3M computes
    them exactly.  ``capacity`` is the per-cell source slot count (0 =
    auto; see _auto_capacity and cell_overflow_fraction);
    ``sr_slabs``/``sr_entries`` are the measured static plan from
    suggest_sr_plan (0 = guaranteed-sufficient bounds).

    Particles the cell tables cannot serve exactly — capacity- or
    plan-overflowed — fall back to MESH-QUALITY full forces on BOTH
    sides of each pair: as sources via the complement-kernel deposit,
    as targets via a complement-of-binned gather, keeping the split
    momentum-symmetric under overflow.

    ``mesh_env`` (make_mesh_env) freezes the robust box and the force-
    kernel spectra to sample-block-entry values: the box drifts slowly
    (it is already 3x-expanded and re-frozen every block), while the
    per-step kernel sampling + forward transforms it replaces are
    ~34 ms/step of the Plummer-262k p3m step (p3m_ablate.log).

    Extra registry options (tiles, interpret) are accepted and ignored
    — the solver has no Pallas tiling."""
    ng = int(grid)
    if ng < 8:
        # ng - 3 usable cells must be positive (ng <= 3 divides by zero
        # -> all-NaN output); anything below 8 is physically useless.
        raise ValueError(f"pm grid must be >= 8, got {ng}")
    f32 = jnp.float32
    # Identity check BEFORE the dtype conversion: numpy astype always
    # copies, so checking after would silently flip every self-solve
    # into between-mode, where massless target copies compete with the
    # sources for cell capacity and one-sidedly lose their exact
    # short-range force (momentum-breaking — found as a ~1e-3 flux
    # asymmetry on overflowing Plummer runs).
    same_set = pos_tgt is pos_src
    pos_tgt = pos_tgt.astype(f32)
    pos_src = pos_src.astype(f32)
    mass_src = mass_src.astype(f32)
    if same_set:
        pos_tgt = pos_src
    if _check_boundary(boundary, box_size):
        # The periodic kernel spectra are constants of the RUN (fixed
        # box, static grid/cutoff) — a mesh_env carries them frozen so
        # the step skips their per-step rebuild (3 ng^3 fftns + ng^3
        # sampling for p3m; this was the round-4 "periodic 2.6x slower
        # than open" anomaly: the env used to be silently ignored
        # here).
        p_spec = None
        if mesh_env:
            p_spec = _check_mesh_env(mesh_env, ng, cutoff_cells,
                                     periodic=True)
        if not cutoff_cells:
            return _periodic_between(pos_tgt, pos_src, mass_src, ng,
                                     float(box_size), spectra=p_spec)
        return _periodic_p3m_between(
            pos_tgt, pos_src, mass_src, same_set, ng, float(box_size),
            int(cutoff_cells), capacity, sr_slabs, sr_entries,
            int(sr_ghosts), differentiable, spectra=p_spec)
    spectra = None
    if mesh_env:
        spectra = _check_mesh_env(mesh_env, ng, cutoff_cells)
        lo_box, hi_box = mesh_env["lo_box"], mesh_env["hi_box"]
    else:
        lo_box, hi_box = _robust_box(pos_src, mass_src)
    span = hi_box - lo_box
    in_src = _inside(pos_src, lo_box, hi_box)  # (Ns,) f32
    in_tgt = _inside(pos_tgt, lo_box, hi_box)  # (Nt,) f32
    m_in = mass_src * in_src
    M_in, com_in, octs = _outlier_moments(pos_src, mass_src, m_in,
                                          lo_box, hi_box, lambda x: x)

    # ng-3 usable cells: one margin cell each side plus the CIC upper corner.
    h = (span / f32(ng - 3))[:, 0]  # (3,)
    inv_h = 1.0 / h[:, None]
    lo = lo_box - h[:, None]  # one-cell margin

    rho = _deposit(pos_src, m_in, lo, inv_h, ng)
    m = 2 * ng
    rho_hat = jnp.fft.fftn(rho, s=(m, m, m))
    if cutoff_cells:
        # P3M: bin the in-box sources into slab-compact cell tables —
        # the mesh then solves the tapered long-range kernel for
        # everyone, PLUS the complement (short-range) kernel for the
        # OVERFLOWED mass the tables cannot cover: overflowed particles
        # contribute and receive mesh-quality FULL forces (pure-PM
        # accuracy) instead of truncated ones — accuracy degrades
        # toward PM, never below it, and stays momentum-symmetric.
        nc, sub = _cell_grid_params(ng, cutoff_cells)
        n_cells = nc * nc * nc
        ns = pos_src.shape[1]
        if same_set:
            pos_bin, m_bin, inc = pos_src, m_in, m_in > 0
        else:
            # Distinct targets join the tables as MASSLESS entries so
            # they can receive the exact short-range sum without
            # exerting force (a zero-mass slab slot is inert).
            pos_bin = jnp.concatenate([pos_src, pos_tgt], axis=1)
            m_bin = jnp.concatenate(
                [m_in, jnp.zeros((pos_tgt.shape[1],), f32)]
            )
            inc = jnp.concatenate([m_in > 0, in_tgt > 0])
        cap, s_max, e_max = _sr_sizing(ns, pos_bin.shape[1], n_cells,
                                       capacity, sr_slabs, sr_entries)
        rc2 = _sr_rc2(span, nc, sub)
        cid = _bin_cids(pos_bin, lo_box, span, nc, inc)
        ptab, mtab, slab_lo, slab_hi, pslot, binned_all = _sr_pack(
            cid, pos_bin, m_bin, n_cells, cap, s_max
        )
        binned = binned_all[:ns]
        m_over = jnp.where(binned, f32(0), m_in)
        # ANY unbinned in-box bin candidate (overflowed source mass OR a
        # truncated massless target copy) activates the complement-mesh
        # machinery; with a suggested capacity the common case is NO
        # overflow, and lax.cond then skips its deposit, 7 (2ng)^3
        # transforms and the extra gather entirely.
        has_over = jnp.any(jnp.logical_and(jnp.logical_not(binned_all),
                                           inc))
        acc_grids, comp_grids = _p3m_force_grids(
            rho_hat,
            lambda: jnp.fft.fftn(
                _deposit(pos_src, m_over, lo, inv_h, ng), s=(m, m, m)),
            h, ng, rc2, has_over, spectra=spectra)
    else:
        acc_grids = _pm_force_grids(rho_hat, h, ng, spectra=spectra)
    acc = _gather(acc_grids, pos_tgt, lo, inv_h, ng)
    if cutoff_cells:
        sym = SR_SYMMETRIC
        wl_t, wl_s, n_e = _sr_ranges(slab_lo, slab_hi, nc, sub, e_max,
                                     symmetric=sym)
        atab = _sr_sweep(ptab, mtab, wl_t, wl_s, n_e, rc2,
                         static_bound=differentiable, symmetric=sym)
        tgt_slot = pslot if same_set else pslot[ns:]
        tgt_binned = binned_all if same_set else binned_all[ns:]
        a_sr = atab[:, tgt_slot]
        a_comp = jax.lax.cond(
            has_over,
            lambda _: _gather(comp_grids, pos_tgt, lo, inv_h, ng),
            lambda _: jnp.zeros((3, pos_tgt.shape[1]), f32),
            operand=None)
        acc = acc + jnp.where(tgt_binned[None, :], a_sr, a_comp)
    acc = jnp.where(in_tgt > 0, acc, _monopole(pos_tgt, M_in, com_in))
    for M_k, com_k in octs:
        acc = acc + _monopole(pos_tgt, M_k, com_k)
    return (acc * f32(G_NEWTON)).astype(f32)


def sharded_accelerations(
    pos_l: jax.Array,
    mass_l: jax.Array,
    axis: str,
    grid: int = DEFAULT_GRID,
    cutoff_cells: int = 0,
    capacity: int = 0,
    sr_slabs: int = 0,
    sr_entries: int = 0,
    sr_ghosts: int = 0,
    boundary: str = "open",
    box_size: float = 0.0,
    mesh_env: dict | None = None,
    **_opts,
) -> jax.Array:
    """Distributed mesh solve for a particle-sharded state — call INSIDE
    shard_map over mesh axis ``axis`` (parallel/decompose.py wires it).

    ``mesh_env`` (make_mesh_env_sharded, built once per sample block
    inside the same shard_map) freezes the psum'd robust box and the
    replicated kernel spectra across the block — the sharded analog of
    the single-device mesh_env, keeping the two paths' traces aligned
    and dropping both the per-step box collectives and the per-step
    kernel transforms.  Open boundary only (periodic needs no env).

    Decomposition of the deposit/solve/gather pipeline.  The
    round-2 sharded pm all-gathered positions and had EVERY shard
    deposit all N sources and FFT the full grid — K shards did K x the
    single-device work (the anti-scalable replicate-and-recompute axis
    of the reference, ver5_all/GSimulation.cpp:170-214).  Here the mesh
    itself is the reduction:

    * box: pmin/pmax exact extents + quantiles of a ~64k-sample gathered
      subsample (_robust_box_sharded) — O(1) comm;
    * deposit: each shard scatters its LOCAL sources only, then ONE
      ``lax.psum`` of the (ng,ng,ng) mass grid — per-shard work O(N/K),
      comm one 4*ng^3-byte grid (8 MB at ng=128);
    * FFT convolution: replicated per shard — O(ng^3 log ng) is cheap
      and replication avoids resharding the spectra;
    * gather + monopole moments: local targets, psum'd octant sums.

    P3M (``cutoff_cells > 0``): the mesh half stays local+psum; the
    exact short-range pass all-gathers sources ONCE per step — the
    particle axis is INDEX-sharded, not spatial, so a local cell list
    would miss cross-shard neighbor pairs.  The slab tables and
    worklist are built replicated (deterministic, so shards agree), the
    SWEEP's entry chunks are split across shards (each shard runs
    ~1/K of the dense pair blocks) and ONE psum reduces the per-slot
    acceleration table; the replicated residue is the table sort and
    the worklist build."""
    from jax import lax

    ng = int(grid)
    if ng < 8:
        raise ValueError(f"pm grid must be >= 8, got {ng}")
    f32 = jnp.float32
    pos_l = pos_l.astype(f32)
    mass_l = mass_l.astype(f32)

    def psum(x):
        return lax.psum(x, axis)

    if _check_boundary(boundary, box_size):
        # Periodic sharded solve is the simplest decomposition of all:
        # the box is STATIC (no psum'd extents), so it is local deposit
        # -> ONE grid psum -> replicated spectral solve (the kernel
        # spectrum is a run constant, frozen in the env when given)
        # -> local gather.
        box = float(box_size)
        p_spec = None
        if mesh_env:
            p_spec = _check_mesh_env(mesh_env, ng, cutoff_cells,
                                     periodic=True)
        rho = psum(_deposit_periodic(pos_l, mass_l, box, ng))
        if not cutoff_cells:
            rho_hat = jnp.fft.fftn(rho)
            if p_spec is not None:
                acc_grids = jnp.stack(
                    [jnp.fft.ifftn(rho_hat * s).real for s in p_spec])
            else:
                acc_grids = _pm_force_grids_periodic(rho_hat, box, ng)
            acc = _gather_periodic(acc_grids, pos_l, box, ng)
            return (acc * f32(G_NEWTON)).astype(f32)
        # Periodic P3M: mesh half local+psum as above; the short-range
        # half follows the open sharded recipe — all-gather sources
        # ONCE (the particle axis is index-sharded, not spatial), build
        # the ghost images and tables REPLICATED (deterministic, so
        # shards agree), split the worklist's entry chunks across
        # shards, one psum of the per-slot table.
        nl = pos_l.shape[1]
        src_w = _wrap_box(pos_l, box)
        pos_all = lax.all_gather(src_w, axis, axis=1, tiled=True)
        m_all = lax.all_gather(mass_l, axis, axis=0, tiled=True)
        nc, sub, rc, nc_tot, lo_cell, span_tot = _periodic_geom(
            ng, cutoff_cells, box)
        rc2 = rc * rc
        n_all = pos_all.shape[1]
        gcap = int(sr_ghosts) or _default_ghost_cap(n_all)
        pos_bin, m_bin, cid, _ = _periodic_ghost_bin(
            pos_all, m_all, box, rc, nc_tot, lo_cell, span_tot, gcap)
        n_cells_tot = nc_tot ** 3
        cap, s_max, e_max = _sr_sizing(n_all, pos_bin.shape[1],
                                       n_cells_tot, capacity, sr_slabs,
                                       sr_entries)
        ptab, mtab, slab_lo, slab_hi, pslot, binned = _sr_pack(
            cid, pos_bin, m_bin, n_cells_tot, cap, s_max)
        i0 = lax.axis_index(axis) * nl
        binned_l = lax.dynamic_slice(binned, (i0,), (nl,))
        m_over_l = jnp.where(binned_l, f32(0), mass_l)
        # The psum'd overflow deposit stays OUTSIDE the cond (every
        # shard runs the same collectives unconditionally); only its
        # fftn defers into the taken branch.
        rho_over = psum(_deposit_periodic(pos_l, m_over_l, box, ng))
        has_over = jnp.any(jnp.logical_and(
            jnp.logical_not(binned[:n_all]), m_all > 0))
        rho_hat = jnp.fft.fftn(rho)
        comb, comp = (p_spec if p_spec is not None
                      else _periodic_p3m_spectra(box, ng, rc2))
        acc_grids, comp_grids = _periodic_p3m_force_grids(
            rho_hat, lambda: jnp.fft.fftn(rho_over), comb, comp,
            has_over)
        acc = _gather_periodic(acc_grids, src_w, box, ng)
        sym = SR_SYMMETRIC
        wl_t, wl_s, n_e = _sr_ranges(slab_lo, slab_hi, nc_tot, sub, e_max,
                                     symmetric=sym)
        k_sh = lax.axis_size(axis)
        k_id = lax.axis_index(axis)
        chunk = 512
        nch_total = -((-e_max) // chunk)
        nch_l = -((-nch_total) // k_sh)
        atab = _sr_sweep(ptab, mtab, wl_t, wl_s, n_e, rc2,
                         chunk=chunk, chunk_lo=k_id * nch_l,
                         chunk_cap=nch_l, symmetric=sym)
        atab = psum(atab)
        a_sr = atab[:, lax.dynamic_slice(pslot, (i0,), (nl,))]
        a_comp = jax.lax.cond(
            has_over,
            lambda _: _gather_periodic(comp_grids, src_w, box, ng),
            lambda _: jnp.zeros((3, nl), f32),
            operand=None)
        acc = acc + jnp.where(binned_l[None, :], a_sr, a_comp)
        return (acc * f32(G_NEWTON)).astype(f32)

    if mesh_env:
        spectra = _check_mesh_env(mesh_env, ng, cutoff_cells)
        lo_box, hi_box = mesh_env["lo_box"], mesh_env["hi_box"]
    else:
        spectra = None
        lo_box, hi_box = _robust_box_sharded(pos_l, mass_l, axis)
    span = hi_box - lo_box
    in_l = _inside(pos_l, lo_box, hi_box)
    m_in_l = mass_l * in_l
    # Per-octant outlier monopoles (see _outlier_moments) — local
    # moments, psum'd.
    M_in, com_in, octs = _outlier_moments(pos_l, mass_l, m_in_l,
                                          lo_box, hi_box, psum)

    h = (span / f32(ng - 3))[:, 0]
    inv_h = 1.0 / h[:, None]
    lo = lo_box - h[:, None]

    rho = psum(_deposit(pos_l, m_in_l, lo, inv_h, ng))
    m = 2 * ng
    rho_hat = jnp.fft.fftn(rho, s=(m, m, m))
    if cutoff_cells:
        nl = pos_l.shape[1]
        pos_all = lax.all_gather(pos_l, axis, axis=1, tiled=True)
        m_in_all = lax.all_gather(m_in_l, axis, axis=0, tiled=True)
        nc, sub = _cell_grid_params(ng, cutoff_cells)
        n_cells = nc * nc * nc
        n_all = pos_all.shape[1]
        cap, s_max, e_max = _sr_sizing(n_all, n_all, n_cells, capacity,
                                       sr_slabs, sr_entries)
        rc2 = _sr_rc2(span, nc, sub)
        cid = _bin_cids(pos_all, lo_box, span, nc, m_in_all > 0)
        ptab, mtab, slab_lo, slab_hi, pslot, binned = _sr_pack(
            cid, pos_all, m_in_all, n_cells, cap, s_max
        )
        # This shard's slice of the global binned flags -> its share of
        # the overflow deposit stays local (then one psum like rho; the
        # deposit+psum stay OUTSIDE the overflow cond so every shard
        # runs the same collectives unconditionally — the cond predicate
        # below is replicated, but keeping collectives out of branches
        # is the simpler invariant).
        i0 = lax.axis_index(axis) * nl
        binned_l = lax.dynamic_slice(binned, (i0,), (nl,))
        m_over_l = jnp.where(binned_l, f32(0), m_in_l)
        rho_over = psum(_deposit(pos_l, m_over_l, lo, inv_h, ng))
        # Replicated predicate (same gathered tables on every shard).
        has_over = jnp.any(jnp.logical_and(jnp.logical_not(binned),
                                           m_in_all > 0))
        acc_grids, comp_grids = _p3m_force_grids(
            rho_hat, lambda: jnp.fft.fftn(rho_over, s=(m, m, m)),
            h, ng, rc2, has_over, spectra=spectra)
    else:
        acc_grids = _pm_force_grids(rho_hat, h, ng, spectra=spectra)
    acc = _gather(acc_grids, pos_l, lo, inv_h, ng)
    if cutoff_cells:
        # Sweep ~1/K of the worklist's entries per shard, psum the
        # per-slot acceleration table once, then serve LOCAL targets
        # from their slots (entries are uniform work units, so the
        # entry-range split load-balances regardless of clustering).
        sym = SR_SYMMETRIC
        wl_t, wl_s, n_e = _sr_ranges(slab_lo, slab_hi, nc, sub, e_max,
                                     symmetric=sym)
        k_sh = lax.axis_size(axis)
        k_id = lax.axis_index(axis)
        chunk = 512
        nch_total = -((-e_max) // chunk)
        nch_l = -((-nch_total) // k_sh)
        atab = _sr_sweep(ptab, mtab, wl_t, wl_s, n_e, rc2,
                         chunk=chunk, chunk_lo=k_id * nch_l,
                         chunk_cap=nch_l, symmetric=sym)
        atab = psum(atab)
        a_sr = atab[:, lax.dynamic_slice(pslot, (i0,), (nl,))]
        a_comp = jax.lax.cond(
            has_over,
            lambda _: _gather(comp_grids, pos_l, lo, inv_h, ng),
            lambda _: jnp.zeros((3, nl), f32),
            operand=None)
        acc = acc + jnp.where(binned_l[None, :], a_sr, a_comp)
    acc = jnp.where(in_l > 0, acc, _monopole(pos_l, M_in, com_in))
    for M_k, com_k in octs:
        acc = acc + _monopole(pos_l, M_k, com_k)
    return (acc * f32(G_NEWTON)).astype(f32)


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _make_periodic_env(ng: int, cutoff_cells: int, box: float) -> dict:
    """Frozen periodic mesh environment: the force-kernel spectra ONLY
    (the box is fixed — no lo/hi to freeze).

    WHEN TO USE (measured, round 5 — periodic_ablate_r5.log): the
    spectra are position-independent run constants, so inside a block
    executable XLA already hoists their in-trace rebuild out of the
    step loop — a cross-executable frozen env (~100 MB of complex64
    inputs at ng=128) measured 25-45 ms/step SLOWER at N=1M than no
    env at all.  The ENGINE therefore passes no env on periodic runs
    (simulation._mesh_env_fn).  This builder exists for consumers
    where the env does not cross an executable boundary (the sharded
    internal-env block traces it inline — free), and for API symmetry
    with the open-boundary env.

    All-static jit (cached per config): called eagerly, the build
    compiles as ONE executable instead of dispatching per op.  Callers
    inside an outer jit just inline."""
    if cutoff_cells:
        _, _, rc, _, _, _ = _periodic_geom(ng, int(cutoff_cells),
                                           float(box))
        return {"spectra": _periodic_p3m_spectra(float(box), ng,
                                                 rc * rc)}
    phi = _periodic_phi_spectrum(float(box), ng)
    k1d = _periodic_kvecs(float(box), ng)
    axes = (k1d[:, None, None], k1d[None, :, None], k1d[None, None, :])
    return {"spectra": tuple((1j * kc) * phi for kc in axes)}


def make_mesh_env_sharded(pos_l, mass_l, axis, grid: int = DEFAULT_GRID,
                          cutoff_cells: int = 0, boundary: str = "open",
                          box_size: float = 0.0, **_opts) -> dict:
    """Sharded counterpart of make_mesh_env: the box comes from the
    psum'd sharded statistics (_robust_box_sharded); the spectra are
    computed replicated (identical on every shard — the box stats are
    collective results).  Call INSIDE shard_map, once per block."""
    ng = int(grid)
    if _check_boundary(boundary, box_size):
        return _make_periodic_env(ng, cutoff_cells, float(box_size))
    f32 = jnp.float32
    lo_box, hi_box = _robust_box_sharded(pos_l.astype(f32),
                                         mass_l.astype(f32), axis)
    span = hi_box - lo_box
    h = (span / f32(ng - 3))[:, 0]
    env = {"lo_box": lo_box, "hi_box": hi_box}
    if cutoff_cells:
        nc, sub = _cell_grid_params(ng, int(cutoff_cells))
        env["spectra"] = _p3m_spectra(h, ng, _sr_rc2(span, nc, sub))
    else:
        env["spectra"] = _force_kernel_spectra(h, ng)
    return env


def make_mesh_env(pos, mass, grid: int = DEFAULT_GRID,
                  cutoff_cells: int = 0, boundary: str = "open",
                  box_size: float = 0.0, **_opts) -> dict:
    """TRACED per-sample-block mesh environment: the robust source box
    and the (2ng)^3 force-kernel spectra, computed ONCE at block entry
    and fed to every step via ``mesh_env=``.

    The spectra depend only on the box (through h and rc2), and the box
    drifts slowly — the reference's analog is the per-run softening/
    timestep constants (ver0/GSimulation.cpp:114-116); here the freeze
    removes ~34 ms/step of kernel sampling + forward transforms from
    the open-boundary p3m step (p3m_ablate.log) at the cost of serving
    intra-block box-leavers by monopole one block early.  Periodic
    solves get a spectra-only env (fixed box; the spectra are run
    constants — see _make_periodic_env).  Plans (suggest_sr_plan) and
    env are refreshed together by the engine's block builder."""
    ng = int(grid)
    if _check_boundary(boundary, box_size):
        return _make_periodic_env(ng, cutoff_cells, float(box_size))
    f32 = jnp.float32
    lo_box, hi_box = _robust_box(pos.astype(f32), mass.astype(f32))
    span = hi_box - lo_box
    h = (span / f32(ng - 3))[:, 0]
    env = {"lo_box": lo_box, "hi_box": hi_box}
    if cutoff_cells:
        nc, sub = _cell_grid_params(ng, int(cutoff_cells))
        env["spectra"] = _p3m_spectra(h, ng, _sr_rc2(span, nc, sub))
    else:
        env["spectra"] = _force_kernel_spectra(h, ng)
    return env


def accelerations(
    pos: jax.Array, mass: jax.Array, grid: int = DEFAULT_GRID,
    cutoff_cells: int = 0, capacity: int = 0, sr_slabs: int = 0,
    sr_entries: int = 0, sr_ghosts: int = 0,
    differentiable: bool = False,
    boundary: str = "open", box_size: float = 0.0,
    mesh_env: dict | None = None, **_opts
) -> jax.Array:
    """All-source mesh accelerations. pos (3,N), mass (N,) -> (3,N).

    ``differentiable=True`` makes the P3M short-range pass
    differentiable (forward and reverse mode): the sweep runs with a
    static loop bound, which also sweeps the padded worklist tail.
    cutoff_cells=0 (plain pm) is natively differentiable either way."""
    return accelerations_between(pos, pos, mass, grid=grid,
                                 cutoff_cells=cutoff_cells,
                                 capacity=capacity, sr_slabs=sr_slabs,
                                 sr_entries=sr_entries,
                                 sr_ghosts=sr_ghosts,
                                 differentiable=differentiable,
                                 boundary=boundary, box_size=box_size,
                                 mesh_env=mesh_env)


def p3m_accelerations(
    pos: jax.Array, mass: jax.Array, grid: int = DEFAULT_GRID,
    cutoff_cells: int = DEFAULT_CUTOFF_CELLS, capacity: int = 0,
    sr_slabs: int = 0, sr_entries: int = 0, sr_ghosts: int = 0,
    differentiable: bool = False,
    boundary: str = "open", box_size: float = 0.0,
    mesh_env: dict | None = None, **_opts
) -> jax.Array:
    """The ``p3m`` registry entry: the mesh solver with the short-range
    correction ON by default (accurate on clustered distributions)."""
    return accelerations_between(
        pos, pos, mass, grid=grid,
        cutoff_cells=cutoff_cells or DEFAULT_CUTOFF_CELLS,
        capacity=capacity, sr_slabs=sr_slabs, sr_entries=sr_entries,
        sr_ghosts=sr_ghosts,
        differentiable=differentiable, boundary=boundary,
        box_size=box_size, mesh_env=mesh_env,
    )


def p3m_accelerations_between(
    pos_tgt: jax.Array, pos_src: jax.Array, mass_src: jax.Array,
    grid: int = DEFAULT_GRID, cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
    capacity: int = 0, sr_slabs: int = 0, sr_entries: int = 0,
    sr_ghosts: int = 0,
    differentiable: bool = False, boundary: str = "open",
    box_size: float = 0.0, **_opts,
) -> jax.Array:
    return accelerations_between(
        pos_tgt, pos_src, mass_src, grid=grid,
        cutoff_cells=cutoff_cells or DEFAULT_CUTOFF_CELLS,
        capacity=capacity, sr_slabs=sr_slabs, sr_entries=sr_entries,
        sr_ghosts=sr_ghosts,
        differentiable=differentiable, boundary=boundary,
        box_size=box_size,
    )


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _cell_counts(pos, mass, grid: int, cutoff_cells: int,
                 boundary: str = "open", box_size: float = 0.0):
    """Per-cell in-box massive-particle counts (n_cells,) for the P3M
    cell list, plus the in-box count (both int32).  Periodic boundaries
    count on the ghost-extended grid INCLUDING the ghost images (a
    capacity must cover the ghost cells too — they mirror the densest
    boundary regions).  Jitted (the engine's per-sample-block health
    check calls this from host code, where eager code dispatches
    per-op)."""
    f32 = jnp.float32
    pos = pos.astype(f32)
    mass = mass.astype(f32)
    if boundary == "periodic":
        box = float(box_size)
        _, _, rc, nc_tot, lo_cell, span_tot = _periodic_geom(
            int(grid), int(cutoff_cells), box)
        src_w = _wrap_box(pos, box)
        _, m_b, cid, _ = _periodic_ghost_bin(
            src_w, mass, box, rc, nc_tot, lo_cell, span_tot,
            7 * pos.shape[1])
        n_cells = nc_tot ** 3
        counts = jnp.zeros((n_cells + 1,), jnp.int32).at[cid].add(1)[:-1]
        return counts, jnp.sum((m_b > 0).astype(jnp.int32))
    lo_box, hi_box = _robust_box(pos, mass)
    nc, _ = _cell_grid_params(int(grid), int(cutoff_cells))
    n_cells = nc * nc * nc
    span = hi_box - lo_box
    m_in = mass * _inside(pos, lo_box, hi_box)
    co = _cell_coords(pos, lo_box, (f32(nc) / span), nc)
    cid = (co[0] * nc + co[1]) * nc + co[2]
    cid = jnp.where(m_in > 0, cid, n_cells)
    counts = jnp.zeros((n_cells + 1,), jnp.int32).at[cid].add(1)[:-1]
    return counts, jnp.sum((m_in > 0).astype(jnp.int32))


def cell_overflow_fraction(
    pos, mass, grid: int = DEFAULT_GRID,
    cutoff_cells: int = DEFAULT_CUTOFF_CELLS, capacity: int = 0,
    boundary: str = "open", box_size: float = 0.0,
) -> jax.Array:
    """Fraction of in-box massive particles NOT binned by the P3M cell
    list (capacity overflow).  Overflowed particles keep a mesh-quality
    FULL force (complement-kernel deposit) but lose short-range
    exactness — a nonzero fraction degrades accuracy toward pure PM for
    those pairs and warrants a larger ``--pm-capacity``.  The
    capacity=0 baseline resolves EXACTLY as the solver's _sr_sizing
    does (periodic boundaries bin on the ghost-extended nc_tot^3 grid,
    which auto-sizes a smaller cap than the core grid — using the core
    grid here once underreported real overflow)."""
    if boundary == "periodic":
        nc, sub = _periodic_cells(int(grid), int(cutoff_cells))
        n_cells = (nc + 2 * sub) ** 3
    else:
        nc, _ = _cell_grid_params(int(grid), int(cutoff_cells))
        n_cells = nc ** 3
    cap = int(capacity) or _auto_capacity(pos.shape[1], n_cells)
    counts, n_in = _cell_counts(pos, mass, int(grid),
                                int(cutoff_cells), boundary,
                                float(box_size))
    return _overflow_frac(counts, n_in, cap)


@functools.partial(jax.jit, static_argnums=(2,))
def _overflow_frac(counts, n_in, cap: int):
    return jnp.sum(jnp.maximum(counts - cap, 0)) / jnp.maximum(n_in, 1)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _ghost_count(pos, mass, grid: int, cutoff_cells: int,
                 box_size: float):
    _, _, rc, _, _, _ = _periodic_geom(int(grid), int(cutoff_cells),
                                       float(box_size))
    src_w = _wrap_box(pos.astype(jnp.float32), float(box_size))
    _, _, n_ghost = _ghost_images(src_w, mass.astype(jnp.float32),
                                  float(box_size), rc, 1)
    return n_ghost


def ghost_overflow_count(
    pos, mass, grid: int = DEFAULT_GRID,
    cutoff_cells: int = DEFAULT_CUTOFF_CELLS, sr_ghosts: int = 0,
    box_size: float = 0.0,
) -> int:
    """Number of periodic ghost images beyond the static ghost cap for
    THIS state — the counterpart of cell_overflow_fraction for the
    _ghost_images drop path, which is otherwise silent at runtime.
    Nonzero means cross-boundary pairs are losing their ENTIRE
    short-range term (tapered long-range-only, momentum-leaking forces
    — see _ghost_images; unlike cell overflow there is no complement
    compensation): raise ``sr_ghosts`` / re-run suggest_sr_plan.  The
    cap baseline (sr_ghosts=0) resolves exactly as the solver does."""
    gcap = int(sr_ghosts) or _default_ghost_cap(pos.shape[1])
    n = int(_ghost_count(pos, mass, int(grid), int(cutoff_cells),
                         float(box_size)))
    return max(0, n - gcap)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _max_occupancy(pos, mass, grid: int, cutoff_cells: int,
                   boundary: str = "open", box_size: float = 0.0):
    counts, _ = _cell_counts(pos, mass, grid, cutoff_cells,
                             boundary, box_size)
    return jnp.max(counts)


def suggest_capacity(
    pos, mass, grid: int = DEFAULT_GRID,
    cutoff_cells: int = DEFAULT_CUTOFF_CELLS,
    headroom: float = 1.25, max_capacity: int = 2048,
    boundary: str = "open", box_size: float = 0.0,
) -> int:
    """HOST-SIDE data-driven cell capacity: the measured max cell
    occupancy x ``headroom``, rounded up to a power of two in
    [64, max_capacity].  Shapes are static under jit, so a traced call
    cannot size the table from the data — the simulation engine calls
    this once per block build with the concrete state instead (clustered
    cores make occupancy wildly data-dependent: Plummer N=8192 peaks at
    ~260/cell while the mean is 0.25).  Beyond max_capacity the
    super-dense cells overflow to mesh-quality forces by design — the
    exact short-range work in a power-law core grows as occupancy^2 and
    belongs to the exact all-pairs kernels."""
    occ = int(_max_occupancy(pos, mass, int(grid), int(cutoff_cells),
                             boundary, float(box_size)))
    cap = 64
    while cap < headroom * occ and cap < max_capacity:
        cap *= 2
    return cap


def _count_layouts(slab_lo, slab_hi, nc: int, sub: int):
    """Worklist entry counts of the full and the symmetric worklist — a
    (2,) i32 vector indexed by ``symmetric``; both in one jitted call,
    so the plan/health machinery compiles once per config."""
    return jnp.stack([
        _sr_ranges(slab_lo, slab_hi, nc, sub, 1, symmetric=sym)[2]
        for sym in (False, True)
    ])


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _sr_plan_counts(pos, mass, grid: int, cutoff: int, cap: int,
                    boundary: str = "open", box_size: float = 0.0):
    """Measured (S, E[2], n_ghost) for the short-range plan: packed slab
    count and the exact worklist entry count _sr_ranges will produce
    for this state for the full and the symmetric worklist (the tables are built at
    the static ceil(Ns/SLAB)+1 bound just for counting; the entry
    count is independent of tail padding)."""
    f32 = jnp.float32
    pos = pos.astype(f32)
    mass = mass.astype(f32)
    ns = pos.shape[1]
    if boundary == "periodic":
        # The solver's periodic binning at the guaranteed 7N ghost
        # bound: measures (S, E) AND the exact image count.
        box = float(box_size)
        _, sub, rc, nc_tot, lo_cell, span_tot = _periodic_geom(
            int(grid), int(cutoff), box)
        src_w = _wrap_box(pos, box)
        pos_b, m_b, cid, n_ghost = _periodic_ghost_bin(
            src_w, mass, box, rc, nc_tot, lo_cell, span_tot, 7 * ns)
        s_cap = pos_b.shape[1] // SLAB + 2
        _, _, slab_lo, slab_hi, _, binned = _sr_pack(
            cid, pos_b, m_b, nc_tot ** 3, int(cap), s_cap)
        n_e2 = _count_layouts(slab_lo, slab_hi, nc_tot, sub)
        n_bin = jnp.sum(binned.astype(jnp.int32))
        return n_bin // SLAB + 2, n_e2, n_ghost
    lo_box, hi_box = _robust_box(pos, mass)
    nc, sub = _cell_grid_params(int(grid), int(cutoff))
    n_cells = nc * nc * nc
    span = hi_box - lo_box
    m_in = mass * _inside(pos, lo_box, hi_box)
    cid = _bin_cids(pos, lo_box, span, nc, m_in > 0)
    s_cap = ns // SLAB + 2
    _, _, slab_lo, slab_hi, _, binned = _sr_pack(
        cid, pos, m_in, n_cells, int(cap), s_cap)
    n_e2 = _count_layouts(slab_lo, slab_hi, nc, sub)
    n_bin = jnp.sum(binned.astype(jnp.int32))
    return n_bin // SLAB + 2, n_e2, jnp.zeros((), jnp.int32)


def _pow2_at_least(x):
    v = 64
    while v < x:
        v *= 2
    return v


def suggest_sr_plan(
    pos, mass, grid: int = DEFAULT_GRID,
    cutoff_cells: int = DEFAULT_CUTOFF_CELLS, capacity: int = 0,
    headroom: float = 1.5, boundary: str = "open",
    box_size: float = 0.0, symmetric: bool | None = None,
) -> dict:
    """HOST-SIDE data-driven short-range plan: the measured slab count S
    and worklist entry count E of the CONCRETE state, x ``headroom`` for
    drift between block builds, rounded up to powers of two so repeated
    re-suggestion over an evolving state yields stable jit shapes.

    ``sr_entries`` is sized for the worklist the solver will trace
    (``symmetric=None``: the module's ``SR_SYMMETRIC``).  The symmetric
    worklist carries about half the entries of the full one, and the
    _sr_ranges expansion cost scales with e_max.  A plan sized for the
    symmetric worklist starves a later trace of the full one; the
    runtime guard is ``sr_entry_overflow`` (wired into the engine's
    per-block plan health check, which re-measures and regrows under
    --pm-replan).  Callers that flip ``SR_SYMMETRIC`` under ONE plan
    pass ``symmetric=False``.

    Static shapes under jit mean a traced call cannot size these from
    the data — the simulation engine calls this once per block build
    (like suggest_capacity); long clustering-evolving runs should
    re-suggest periodically (scripts/exp_p3m_stress.py does per
    sub-block).  Returns kwargs for the p3m entries:
    ``{"capacity", "sr_slabs", "sr_entries"}``."""
    cap = int(capacity) or suggest_capacity(pos, mass, grid, cutoff_cells,
                                            boundary=boundary,
                                            box_size=box_size)
    s, e2, g = _sr_plan_counts(pos, mass, int(grid), int(cutoff_cells),
                               cap, boundary, float(box_size))
    s_planned = _pow2_at_least(int(s) * headroom)
    sym = SR_SYMMETRIC if symmetric is None else symmetric
    e = int(e2[int(sym)])
    plan = {
        "capacity": cap,
        "sr_slabs": s_planned,
        "sr_entries": _pow2_at_least(e * headroom),
    }
    if boundary == "periodic":
        # Measured image count (exact for THIS state; headroom for
        # drift), capped at the guaranteed bound.
        plan["sr_ghosts"] = min(_pow2_at_least(int(g) * headroom),
                                7 * pos.shape[1])
    return plan


def sr_entry_overflow(
    pos, mass, grid: int = DEFAULT_GRID,
    cutoff_cells: int = DEFAULT_CUTOFF_CELLS, capacity: int = 0,
    sr_slabs: int = 0, sr_entries: int = 0,
    boundary: str = "open", box_size: float = 0.0,
) -> int:
    """Worklist entries the CURRENT state would overflow past the
    static ``sr_entries`` plan for the active worklist (``SR_SYMMETRIC``)
    — the runtime guard that makes worklist-specific plan sizing
    (suggest_sr_plan) safe.
    Overflowed entries are DROPPED by _sr_ranges: the affected slab
    pairs silently lose their entire short-range correction (worse
    than cell overflow, which keeps mesh-quality forces), so ANY
    nonzero return means the plan must grow — the engine's per-block
    health check (simulation._check_sr_health) treats it like dropped
    ghosts and replans under --pm-replan.  ``sr_entries=0`` resolves to
    the guaranteed bound (cannot drop entries) and returns 0."""
    if not int(sr_entries):
        return 0
    if boundary == "periodic":
        nc, sub = _periodic_cells(int(grid), int(cutoff_cells))
        n_cells = (nc + 2 * sub) ** 3
    else:
        nc, _ = _cell_grid_params(int(grid), int(cutoff_cells))
        n_cells = nc ** 3
    ns = pos.shape[1]
    cap, s_max, e_max = _sr_sizing(ns, ns, n_cells, capacity,
                                   sr_slabs, sr_entries)
    _, e2, _ = _sr_plan_counts(pos, mass, int(grid), int(cutoff_cells),
                               cap, boundary, float(box_size))
    n_e = int(e2[int(SR_SYMMETRIC)])
    return max(0, n_e - e_max)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def force_error_vs_exact(pos, mass, grid: int = DEFAULT_GRID,
                         cutoff_cells: int = 0, capacity: int = 0):
    """Relative L2 force error of the mesh solve (pm, or p3m when
    ``cutoff_cells`` > 0) vs the exact all-pairs kernel (diagnostic used
    by tests and docs measurements)."""
    from . import naive

    a_pm = accelerations(pos, mass, grid=grid, cutoff_cells=cutoff_cells,
                         capacity=capacity)
    a_ref = naive.accelerations(pos, mass)
    num = jnp.sqrt(jnp.sum((a_pm - a_ref) ** 2))
    den = jnp.sqrt(jnp.sum(a_ref ** 2))
    return num / jnp.maximum(den, 1e-30)
