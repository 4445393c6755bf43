#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``warpx_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

It runs every phase, in order (but for the eleven per-particle paths
main_lwfa_ionization, main_qed, main_coulomb, main_fusion, main_mcc_dsmc,
main_mr, main_lwfa_mr, main_rz_lwfa, main_rz_psatd, main_dist and
main_lwfa_pdist, which launch none of the kernels and run first, while the
kernels compile); each prints one JSON line and any failure exits
non-zero:

  device       the card's name, count and power limit;
  build        compile every kernel under warpx_tpu_torch/csrc with nvcc,
               one nvcc a source, all started together at the lowest
               priority before the eleven paths above, and waited for
               after them;
  k1_parity    kernel K1 (fused gather/push/deposit) against its plain
               PyTorch version at 16^3, two species, orders 1-3, the Boris,
               Vay and Higuera-Cary pushers, float64 and float32, each case
               launched K1_REPEATS times (its shared-memory atomics sum in
               an order that changes from launch to launch); then K1's
               branch cases (``branch_inputs``: a window wider than K1's
               shared box, a tile whose particles reach past the box, dead
               slots like and unlike their row's first, dead slots with a
               weight, a stencil clipped at the window's low side, a
               counted violation, an all-empty tile, external fields) in
               float64 and float32, every mode, orders 1-3, Galerkin on and
               off;
  k2_parity    kernel K2 (the 2D XZ fused kernel) against its plain version
               at 32^2, the same cases and launches, then K2's branch
               cases;
  k1d_parity   K1 and K2 in the precision modes 'mixed' and 'bf16' (kernel
               mode K1d), the same cases and launches, float32 to TOL_MXU,
               and each mode once per kernel in moving-window mode;
  k1c_parity   K1 and K2 in moving-window mode (smax = 8, zshift 0, 3 and 8,
               tiles anchored off prob_lo) against their plain versions, and
               the mode's neutral arguments against the call without them;
               then K1's and K2's branch cases in moving-window mode
               (zshift 3);
  k3_parity    kernel K3 (rebin slot expansion) against its plain version,
               also on a rebin's payload with an integer and a real runtime
               attribute as further rows;
  lab_parity   the four kernels of the Hopper labs (warpx_tpu_torch/tools/:
               lab_fused, lab_widelane, tile_dot, slot_copy) against their
               plain versions at small shapes, every mode and both layouts,
               each case launched three times (slot_copy exactly); layout
               NT of tile_dot also at edge shapes of its plan (K not a
               multiple of the slice, n not of 64, M = 8 and 40), lab_fused
               at W 16 and 8 with P a multiple of 64 but not of its chunk,
               and the refusals;
  slice_parity 4 steps of Simulation at 16^3 in float64 on the card and on
               the CPU: every checksum but divE/divB agrees to 1e-9;
  slice2d_parity  the same for the 2D slice at 32^2, 8 steps;
  bounded_parity  the bounded step in float64 on the card (kernels) and on
               the CPU (plain versions): the 32 x 64 laser-wakefield deck
               (PML, moving window, antenna, continuous injection, beam,
               filter, order 3; 12 steps, K2 in moving-window mode) and the
               16^3 deck with PEC walls along z (three particles per cell,
               5 steps, K1): every
               checksum but divE/divB agrees to 1e-9, the window moved, the
               kernels were launched once per step;
  deck_parity  the 32 x 64 deck at tpu.tile_mxu = mixed through
               Simulation.from_deck, card against CPU, 12 steps (1e-9); then
               the CLI (python -m warpx_tpu_torch) on the card as a process
               of its own, its checksums against an in-process run;
  psatd_parity the standard PSATD solver in float64 on the card against
               the CPU: PsatdSolver.push (3D, 2D) and PsatdPmlSolver.push
               (F/G splits) on seeded fields to 1e-12 (cuFFT against
               pocketfft); then the 16^3 periodic deck (K1, psatd_order 16
               on guard-padded boxes), the 32^2 one (K2, one periodic box,
               order 3) and the 32 x 64 laser-wakefield deck (K1c, PML with
               F/G splits, 8 steps), tile-binned: every checksum within
               1e-9, divE/divB within 1e-9 of their largest value cell by
               cell, the fused kernel launched once per step;
  psatd_variants_parity  the rest of PSATD in float64, card against CPU:
               each new solver push alone (J linear in time, first order
               with and without F/G cleaning, time-averaged Galilean,
               comoving, Vay) to 1e-12; every family (Galilean, averaged,
               current correction, multi-J second and first order, Vay,
               direct, F/G cleaning, comoving) on the 16^3 and 32^2
               periodic decks per particle, 2 steps; first-order PSATD
               with J constant through the tile-binned step (K1, K2, K3);
               the rho-free time-averaged and comoving decks refused; the
               32 x 64 laser-wakefield deck with psatd.v_galilean and the
               moving window (with and without time averaging) and with
               PSATD's default direct deposition, per particle: checksums
               within 1e-9, divE/divB within 1e-9 of their largest value
               cell by cell; the float32 spread of the 32 x 64 decks;
  boosted_parity  the boosted frame, back-transformed diagnostics and
               divergence cleaning in float64, card against CPU: the 32 x 64
               laser-wakefield deck at gamma_boost = 10, tile-binned (K1c)
               and per particle; that deck with a BackTransformed
               diagnostic (rows and filled masks); the 16^3 periodic plasma
               under Yee with both cleanings from divergent fields; the
               32 x 64 deck with both cleanings under Yee and PSATD with
               PML faces: checksums, sum |F| and sum |G| within 1e-9, and
               each case's float32 spread;
  main         the 3D main path at 128^3 cells, 2 species, 8.39 M particles,
               float32: init, one warm step, 20 timed steps, 3 profiled
               steps, the closing step; then each kernel at the main path's
               shapes against its plain version, timed beside its bound;
  main_psatd   uniform-128-psatd: main's plasma and dt with the PSATD
               solver (psatd_order 16), driven as main is, then one
               spectral push timed alone (FFT calls, kernel launches,
               device ms);
  main_psatd_galilean  uniform-128-galilean: main's plasma and dt, both
               species drifting along z at gamma = 10, Galilean PSATD at
               the drift's velocity with update-with-rho, Esirkepov
               deposition, per particle, 13 steps (8 timed): ms a step,
               the device's busy share, peak memory, each deposit's device
               ms, the field energy after the first step and at the end;
               then the spectral push timed alone;
  main_psatd_multij  uniform-128-multij: the same drifting plasma with
               first-order PSATD, two depositions a step, J and rho
               constant in time, F/G cleaning, direct deposition, per
               particle, driven and reported as main_psatd_galilean;
  main_mixed   the same path at tile_mxu = 'mixed' (bench.py's default), and
               main_bf16 at 'bf16'; K1 in each mode at its shapes against
               its plain version, timed beside K1 at 'f32';
  main2d       the 2D main path at 2048^2 cells, 2 species, 33.6 M particles,
               order 3, float32: init, one warm step, 33 timed steps (rebins
               at steps 16 and 32), 3 profiled steps, the closing step; then
               K2 and K3 at its shapes as above;
  main_lwfa    the bounded main path, bench.py's 2D laser-wakefield deck at
               2048 x 8192 cells (PML on four faces, moving window along z,
               Gaussian laser antenna, continuously injected plasma of
               ~45 M electrons at 2 x 2 per cell, a 100-particle beam,
               bilinear filter, order 3, sort interval 16), float32: init,
               4 warm steps, 16 timed steps, 4 steps with the host's waits
               for the device counted, a rebin step, 3 profiled steps, the
               closing steps (30 in all);
               then the step's layers timed one by one, and K2 in
               moving-window mode (K1c)
               at its shapes against its plain version, timed beside its
               bound;
  main_lwfa_deck  the same run from bench.py's deck text (a copy here)
               through Simulation.from_deck at tpu.tile_mxu = mixed, as
               bench.py runs it; then K2 in moving-window mode at 'mixed'
               against its plain version, timed beside K1c at 'f32';
  main_lwfa_diags  the same deck at 'mixed' with outputs, as a user runs
               it (Simulation.from_deck with an output directory), 24 steps:
               a plotfile of Ex Ez By jz rho and both species at step 24,
               read back and held exactly against the tensors it was
               written from; a checkpoint at 12; eight reduced
               diagnostics every 4 steps (rows and ParticleNumber checked);
               an openPMD file of the beam at 24 where h5py is installed
               (held against the plotfile's beam); the host's waits for the
               device on steps with no output due against main_lwfa_deck's
               steps without a rebin; each flush kind timed (ms, bytes
               written, bytes from the device: the plotfile and the
               checkpoint where the run wrote them, the others alone on the
               final state); then a fresh simulation of the deck without
               the plotfile and openPMD outputs restarted from the
               checkpoint and run to 24, its checksums within TOL_RESTART
               of the run's;
  main_lwfa_psatd  lwfa2d-2048x8192-psatd: bench.py's deck text with the
               PSATD solver and Esirkepov deposition at 'mixed' (spectral
               PML with F/G splits), 20 steps driven as main_lwfa is; then
               the spectral push with its PML splits timed alone, and K1c at
               'mixed' at its shapes against its plain version;
  main_lwfa_boosted  lwfa2d-2048x8192-boosted: bench.py's deck at 'mixed',
               translated +36 um along z, with gamma_boost = 10 and a
               4-snapshot BackTransformed diagnostic whose planes cross the
               plasma, tile-binned through K1c and K3 at the default tile
               headroom, driven as main_lwfa is but for its 16 warm and 16
               counted steps (54 in all); the fullest tile after
               each rebin, every filled row holding data and matching an
               independent float64 back-transform of the slices, the slab's
               rho against the whole grid's, one row's work timed alone,
               the host's waits on quiet steps against main_lwfa_deck's,
               K1c at its shapes;
  main_lwfa_boosted_galilean  bench.py's deck (untranslated) at
               gamma_boost = 10 under Galilean PSATD
               (psatd.use_default_v_galilean), per particle, 10 steps:
               ms a step, busy share, the deposits' and the push's ms;
  main_divclean  uniform-128 with both cleanings under Yee, per particle:
               ms a step, the rho pair's ms, max |F|, |G| (G at roundoff);
  stochastic_parity  (after boosted_parity) field ionization (the 32 x 64
               deck with a nitrogen dopant), quantum synchrotron and
               Breit-Wheeler with photon species (16^2), Schwinger (16^3),
               radiation reaction with photons (16^2) and both thinnings
               per particle and tile-binned (16^3; K1, K3) in float64, card
               against CPU on the numbers of one CPU generator
               (``CpuDraws``): fields, species and attributes within 1e-12
               (thinnings 1e-9), checksums 1e-9; float32 spreads reported;
  main_lwfa_ionization  bench.py's LWFA deck at 2048 x 8192 with a
               nitrogen dopant at N5+ around the antenna, per particle, 3
               timed steps: each step's events against an independent
               float64 host ADK evaluation on the card's gathered fields
               (5 sigma over the run), products placed and dropped, ions by
               level, the ionization operator's device ms;
  main_qed     a 128^3 QED box (2.5 nm cells): four quantum-synchrotron
               leptons, four Breit-Wheeler photon species, a
               radiation-reaction species, 1 per cell each: photon and
               pair yields after the second step within 5 sigma of the
               analytic rates, electrons equal to positrons, the
               radiation-reaction momenta against a float64 host pusher;
  main_schwinger  128^3 under the reference's Schwinger case-2 field held
               (no Maxwell solver), a 16-cell slab producing: each step's
               pair weight against dV dt rate, electron and positron
               weights equal;
  main_resampling  uniform-128 (ions at 8 a cell) with leveling every 5
               steps and velocity coincidence every 10, tile-binned (K1,
               K3), 25 steps: each pass's count against its expectation,
               the electrons' weight within 5 sigma, each cell's weight and
               momentum conserved by the merge, K1 before and after;
  collision_parity  (after stochastic_parity) every collision of a 16^3
               deck (intra and inter Coulomb, D-T, D-D and p-B11 fusion)
               and a 32^2 deck (DSMC, MCC with ionization, stopping) alone
               on its initial state, float64, card against CPU on one CPU
               generator's numbers (1e-12), the (cell, random) order
               identical; three steps of both decks and of the bounded
               32 x 64 laser-wakefield deck with MCC and stopping (1e-9);
               float32 spreads reported;
  main_coulomb uniform-128-coulomb (33.5 M slots, Yee, per particle, intra
               e-e, i-i and inter e-i Coulomb): each collision alone
               conserves momentum and energy, 10 timed steps with each
               collision's device ms, the drift difference falls, float32
               changes the momenta float64 changes (at 32^3);
  main_fusion  fusion-128 (D-T at 4 a cell, p-B11 at 1 a cell, products):
               10 steps, the events against the float64 sum of the pairs'
               probabilities (5 sigma), momentum, energy and weight per
               event, no product dropped; 3 clean timed steps;
  main_mcc_dsmc  mcc-dsmc-128 (electrons on helium with MCC scattering and
               ionization, He+ and He with DSMC elastic and charge
               exchange, He+ stopping): scatterings and ionizations within
               5 sigma, stopping against its closed form, charge exchange a
               swap; 3 clean timed steps;
  injection_parity  (after collision_parity) Queue A 11.2 and 11.5 in
               float64, card against CPU: every injection style and
               momentum distribution but the openPMD file (16^3), constant
               and parsed external grid fields (16^3, and 32^2 with PEC
               walls), order-4 shapes (16^3, 32^2, the bounded 32 x 64
               laser-wakefield deck), all per particle, and the 16^3 flux
               deck on one CPU generator's numbers: the initial particles
               identical, 3 steps within 1e-9; lasy_amplitude of a
               cartesian and a thetaMode envelope built from arrays, card
               against CPU; then the plane emission on the card's own
               generator held statistically (count and weights exact, the
               flight within a step, the normal momentum's mean and
               variance and the tangential ones within 5 standard errors);
  main_flux    flux-128: uniform-128's plasma loaded Maxwell-Boltzmann under
               Bz = 1 T set on the grid, protons emitted from a plane
               (32,768 a step), per particle, 10 timed steps: ms a step,
               the injector's device ms, busy share, the protons alive
               exactly as emitted, none dropped, no fused launch;
  main_lwfa_lasy  lwfa2d-2048x8192-lasy: main_lwfa_deck's deck with the
               laser read from a lasy envelope of its own Gaussian (handed
               to the loader's cache: the card has no h5py), 20 steps
               through K1c and K3: every step's antenna amplitudes against
               the Gaussian's, K1c's device ms, the rebins, zero overflow;
  main_shape4  uniform2d-2048-order4: main2d's plasma at particle_shape
               = 4, per particle, 4 steps: ms a step, the deposits' and the
               gathers' device ms, the order-4 Esirkepov deposit's
               continuity residual in float64 (at roundoff);
  es_parity    (after injection_parity) Queue A 11.3's first half in
               float64, card against CPU: the lab-frame, relativistic and
               magnetostatic solves, an open 12^3 box through the
               integrated Green function, Dirichlet walls under f(t)
               potentials (a box bounded along every axis, and one
               periodic along x), a 2D hybrid-PIC plasma, a conducting
               dielectric, and the NCI corrector on the periodic step and
               on the bounded 32 x 64 deck per particle and tile-binned
               (K1c): checksums and phi / the hybrid temporaries within
               1e-9;
  main_es      uniform-128-es: main's plasma under the lab-frame
               electrostatic solver between Dirichlet z walls (0 and
               100 V sin(2 pi t / 40 dt)), 10 steps per particle: the
               Poisson residual, the wall potential exact, E = -grad(phi)
               bitwise; ms a step, the solve's ms, busy share;
  main_es_open  beam-128-igf: 2^24 electrons at u_z = 1000 on an open
               128^3 box through the integrated Green function: E against
               Bassetti-Erskine (4 %), B = beta x E / c; the IGF solve's
               ms and ms a step over 3 steps;
  main_hybrid  uniform-128-hybrid: 16.8 M protons with fluid electrons,
               10 RK4 substeps, 10 steps: finite fields, the ions kept,
               div B at roundoff; the field advance's device ms and
               launches;
  main_macroscopic  dielectric-128: a standing wave in eps = 4 eps0 at
               128^3 in float64 (omega within 1e-9 of the Yee dispersion,
               5e-3 of k c/2) and the uniform conductor's alpha^n (1e-12);
  main_lwfa_boosted_nci  main_lwfa_boosted's deck with the NCI corrector,
               20 steps through K1c and K3: ms a step beside
               main_lwfa_boosted's, K1c's ms, the corrector's ms, the
               plasma's field energy with and without the corrector;
  nci_drift    tests/test_nci.py's drifting plasma, 600 steps in float32
               with and without the corrector, replayed from a CUDA graph
               of the per-particle step: the energy ratio above 30;
  fieldsolver2_parity  (after es_parity) Queue A 11.3's second half in
               float64, card against CPU: theta-implicit Picard at 16^3,
               semi-implicit at 32^2, Newton-GMRES at 16^2, a 3D cold-fluid
               Langmuir deck, the 2D ECT rotated cube, a bounded 3D Yee
               plasma streaming into an eb2 sphere, ChargeOnEB on its
               state: checksums and the fluid state within 1e-9, the
               nonlinear iteration counts equal;
  main_implicit  uniform-128-implicit: main's plasma (8.39 M) theta-
               implicit at theta = 1/2, Picard to 1e-12, float64, dt at half
               the Courant limit, 1 step: energy drift at most 1e-10,
               Picard iterations, ms a step, peak memory, busy share;
  main_implicit_jfnk  uniform2d-256-jfnk: 256^2, 4 particles a cell,
               Newton (1e-12) with GMRES (restart 30), float64, 2 steps:
               energy drift at most 1e-10, Newton and GMRES iterations,
               one JVP's ms against one right-hand side's;
  main_fluid   fluid-128-langmuir: a cold electron fluid at 128^3,
               float32, u_x = u0 sin(k x) over two plasma periods: sum N
               to 1e-5, the frequency within 1 % of omega_pe, ms a step;
  main_ect     the reference's rotated-cube TM mode under ECT at 64^3
               (theta = pi/6) and 32^2 (pi/8), ~1.125 periods: By and Bz
               against the analytic mode (1e-2 in 3D, 1e-1 in 2D); the
               same under Yee on the same staircase, the cut-cell
               geometry's host time, ms a step;
  main_eb      uniform-128-eb: main's plasma in a PEC box with an eb2
               sphere, Yee, 5 steps: after every step no alive particle
               inside the body and the covered E edges and B faces
               bitwise at their initial values; ChargeOnEB, ms a step;
  dims1_parity (after boundaries_parity) 1D Cartesian geometry and the
               runtime attributes in float64, card against CPU: the periodic
               1D step under Esirkepov, direct and villasenor deposition at
               orders 1-3, collocated, PSATD and electrostatic; the 1D
               laser-wakefield deck and the antenna through PML and
               Silver-Mueller faces; the attributes through the tile-binned
               2D steps (K2, K2 in moving-window mode, K3); a boosted
               backward-propagating Gaussian beam: 1e-12 per particle,
               1e-9 binned and for checksums, no kernel in 1D;
  main_1d      uniform1d-1M: 1,048,576 cells, 16.8 M electrons, order 3,
               Esirkepov, per particle, 40 steps in float64 (the Langmuir
               frequency within 2 % of Bohm-Gross, the weight kept, no
               kernel launched; ms a step, pushes/s, busy share) and in
               float32 (reported: its positions do not resolve a step's
               motion 0.1 m from the origin);
  main_lwfa_1d lwfa1d-4096: the 1D laser-wakefield deck at lambda/32 over
               4096 cells, 256 electrons a cell, 450 steps: the pulse's
               peak |Ey| within 5 % of e_max, the alive count and the
               regionofinterest count exact, initialenergy as injected;
  mr_parity    (after dims1_parity) mesh refinement in float64, card
               against CPU: the periodic step in 2D and 3D, subcycled,
               subcycled under the NCI corrector, momentum-conserving, and
               the bounded 32 x 64 laser-wakefield deck with a patch riding
               the window, PML and refine_plasma: states, patch arrays and
               the lev=0/lev=1 checksums within 1e-9, no kernel;
  main_mr      (while the kernels compile) uniform-128-mr: main's plasma
               (8.39 M) with a ratio-2 patch over the central 64^3 cells,
               per particle, float32, plain and subcycled: ms a step,
               pushes/s, busy share, the patch's work alone, the level-1
               share of the particles against the patch's volume share;
               finite fields on both levels, the weight bitwise, no
               kernel;
  main_lwfa_mr (while the kernels compile) lwfa2d-2048x8192-mr:
               main_lwfa's deck with a ratio-2 patch of 512 x 1024 cells
               around the antenna riding the window, refine_plasma on (95
               M electrons), per particle, float32: ms a step, busy share,
               the patch's work alone; the alive count exactly the refined
               lattice's between the window's edge and the injection
               front, finite fields, no kernel;
  rz_parity    (after mr_parity) RZ in float64, card against CPU: the
               RZ Langmuir wave at 2 modes, the RZ LWFA at 32 x 256 (PEC z
               walls, the window, the antenna, continuous injection with
               random_theta, a Gaussian beam), Silver-Mueller faces, a
               laser around an embedded disk, PSATD standard, with current
               correction and Galilean: fields (F and the rings too),
               species and the RZ checksums within 1e-9, no kernel;
  main_rz_lwfa (while the kernels compile) rz-lwfa-1024x8192: the
               reference's RZ LWFA in form at this repo's LWFA cells, 2
               modes, PEC z walls, the window, the antenna, 33.5 M
               electrons with random_theta and continuous injection, a
               Gaussian beam, order 3, float32, per particle: ms a step,
               pushes/s, busy share, host init; the alive count exactly
               the injection plan's, the antenna's m = 1 field nonzero,
               finite fields, no kernel;
  main_rz_psatd (while the kernels compile) rz-psatd-galilean-512x4096:
               the Galilean RZ plasma at 512 x 4096, 2 modes, noz = 16,
               electrons and protons drifting at u_z = 10 (16 M), the
               direct cell-centered deposit, order 3, float32: ms a step,
               busy share, the spectral push, each transform and the
               deposits alone, the field energy against the kinetic; no
               particle lost, finite fields, no kernel;
  dist_parity  (after rz_parity) Queue A 14 in float64 on one rank (a
               process group of this process alone: NCCL for the card,
               gloo for the CPU), card against CPU: the periodic 2D
               Langmuir and 3D thermal decks of tests/test_torch_sharded.py
               through DistSimulation, the corner plasma of
               tests/test_load_balance.py after a load_balance() and a
               forced switch to the balanced step and half push, the
               32 x 64 laser-wakefield and 16^3 PEC decks through
               ParticleDistSimulation: states and checksums within 1e-9,
               no particle lost, no kernel;
  main_dist    (while the kernels compile) uniform-128-dist: main's plasma
               (8,388,608 particles, order 1, Yee, float32) through
               DistSimulation(cfg, {"z": 1}) over NCCL, per particle, 8
               steps (5 timed, 1 profiled): ms a step, pushes/s, busy
               share, lost = 0, one load_balance() alone; the checksums
               within TOL_DIST_F32 of the single-card per-particle step's,
               which runs after it, driven the same way;
  main_lwfa_pdist (while the kernels compile) lwfa2d-2048x8192-pdist:
               main_lwfa's configuration (44.7 M electrons) through
               ParticleDistSimulation over NCCL, per particle, 6 steps (3
               timed, 1 profiled): ms a step, busy share, the J
               all-reduce alone; the live count the single-card
               per-particle run's exactly;
  labs         each Hopper lab's main() at the TPU lab's default shapes (L1
               in every mode): kernel against plain version, times, bounds,
               the library's yardstick where there is one; each lab prints
               its lines and one JSON line.

The build line reports every library's registers and spill bytes (ptxas);
the kernels line gives K1's and K2's rows their registers, spills,
resident blocks per SM and the tiles of one launch that took the checked
path (``wide_tiles``).  The line before the last lists the kernels; the last
line is
{"ok": true, "device": {...}}.  With no GPU, or without the package beside
this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: HBM3 rate and the dense rates outside the
# tensor cores (float64 34, float32 67 TFLOP/s), at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# The main paths' current windows in float32: their thermal particles drift
# ~0.006 cells a step, and the current is a difference of shape factors over
# that drift.  Kernel and plain version push with velocities that differ in
# the 7th digit, so now and then x_new rounds to the neighbouring float32
# (2^-20 cells at W = 16, 2^-19 at W = 24), which moves that particle's
# current by ~1e-6/0.006 ~ 2e-4 of itself.  1e-4 of the largest window value
# bounds it.
TOL_J_MAIN = 1e-4
# The same for the laser-wakefield path's windows: at W = 48 an ulp of the
# window coordinate is 2^-18 cells, and the plasma is at rest but for what the
# laser's leading edge moves (a drift of a few hundredths of a cell a step
# carries the largest current), so one ulp of x_new is ~1e-4 of the largest
# window value; 8.2e-5 was measured.
TOL_J_WINDOW = 4e-4
# K1 at 'bf16' at the main path's shapes: an ulp of x_new that carries a
# deposit operand across a bfloat16 rounding boundary moves that point's
# value by up to 2^-8 (3.9e-3) of itself, and the point may hold the largest
# window value; 3.3e-4 was measured at uniform-128 after 25 steps.
TOL_J_BF16 = 4e-3


T_START = time.perf_counter()


def emit(phase, **kw):
    """One JSON line for ``phase``, with the seconds since the script
    started (``elapsed_s``: where the script's time goes)."""
    print(json.dumps({"phase": phase, **kw,
                      "elapsed_s": time.perf_counter() - T_START}),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` from CUDA events around ``reps`` calls
    made back to back, so the host's work of one call overlaps the device's
    work of the one before."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def rel_err(got, ref):
    """(max |got - ref|, that over max |ref|) in float64."""
    d = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    return d, d / scale if scale else d


# ---- kernels K1 (3D) and K2 (2D) -------------------------------------------

def kernel_inputs(ndim, n, order, dtype, dev, seed, smax=0, anchor_off=0.0,
                  margin=1):
    """Two species in the tile layout at n^ndim with random fields, dead
    slots, one empty (species, tile) and one alive particle whose deposit
    stencil is clipped at its window's low side (a counted violation).
    With ``smax`` the padded fields are that much longer on the last axis;
    with ``anchor_off`` the tiles are anchored that many cells above
    prob_lo; ``margin`` is the tiling's sort margin in cells.  Returns
    ((params, fields6, parts), counts, keywords, anchors).
    """
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.core.state import ParticleState
    from warpx_tpu_torch.ops.fused_pic import pad_fields, padded_shape
    from warpx_tpu_torch.ops.tiling import TileSpec, rebin
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    rng = np.random.default_rng(seed)
    lx = 40e-6
    geom = Geometry(ndim=ndim, n_cell=(n,) * ndim, prob_lo=(-lx / 2,) * ndim,
                    prob_hi=(lx / 2,) * ndim, periodic=(True,) * ndim)
    dt = compute_dt_yee(geom, 0.999)
    npart = 2 * n ** ndim
    spec = TileSpec.create(geom.n_cell, order=order, n_particles=npart,
                           margin=margin, interval=4)
    c = 299792458.0
    t64 = dict(dtype=torch.float64)
    names = ("x", "z") if ndim == 2 else ("x", "y", "z")
    parts = []
    for s in range(2):
        alive = rng.random(npart) > 0.1
        pos = rng.uniform(-lx / 2, lx / 2, (ndim, npart))
        if s == 1:  # leave tile 0 empty for this species
            alive &= ~np.all(pos < -lx / 2 + spec.tile[0] * geom.dx[0],
                             axis=0)
        u = rng.normal(0.0, 0.05 * c, (3, npart))
        sp = ParticleState(
            w=torch.tensor(rng.uniform(0.5, 1.5, npart) * 1e10 * alive, **t64),
            ux=torch.tensor(u[0], **t64), uy=torch.tensor(u[1], **t64),
            uz=torch.tensor(u[2], **t64), alive=torch.tensor(alive),
            **{nm: torch.tensor(pos[d], **t64) for d, nm in enumerate(names)},
        )
        sp, _ = rebin(sp, geom, spec)
        parts.append(sp)
    # first alive slot of species 0 in its tile: move it so the stencil
    # start of its x deposit is window row -1
    sp0 = parts[0]
    k = int(torch.nonzero(sp0.alive)[0])
    t = k // spec.p_max
    tx = t // int(np.prod(spec.tiles_per_dim[1:]))
    xwin = 0.25 + 0.5 * order  # start_index(x, order) == 0
    x = sp0.x.clone()
    x[k] = geom.prob_lo[0] + (tx * spec.tile[0] - spec.off + xwin) * geom.dx[0]
    ux = sp0.ux.clone()
    ux[k] = 0.0
    parts[0] = sp0.replace(x=x, ux=ux)
    nt, P = spec.n_tiles, spec.p_max
    anchors = tuple(lo + anchor_off * d
                    for lo, d in zip(geom.prob_lo, geom.dx))
    cols = [torch.cat([getattr(sp, a).reshape(nt, P) for sp in parts])
            + anchor_off * geom.dx[d] for d, a in enumerate(names)]
    cols += [torch.cat([getattr(sp, a).reshape(nt, P) for sp in parts])
             for a in ("ux", "uy", "uz")]
    cols.append(torch.cat([torch.where(sp.alive, sp.w, 0.0).reshape(nt, P)
                           for sp in parts]))
    counts = torch.cat([sp.alive.reshape(nt, P).sum(1, dtype=torch.int32)
                        for sp in parts])
    if int((counts == 0).sum()) < 1:
        raise AssertionError("the test layout lost its empty tile")
    to = dict(dtype=dtype, device=dev)
    fshape = geom.n_cell if smax == 0 else padded_shape(spec, geom.n_cell,
                                                        smax)
    fields = tuple(torch.tensor(rng.normal(0, scale, fshape), **t64).to(**to)
                   for scale in (1e10,) * 3 + (30.0,) * 3)
    if smax == 0:
        fields = pad_fields(fields, spec)
    params = torch.tensor([[-1.602176634e-19, 9.1093837015e-31, 1e9, 0, 0,
                            0, 0, 1.0],
                           [1.602176634e-19, 1.67262192369e-27, 0, 0, 0,
                            0, 0, 0]], **t64)
    args = (params.to(**to), fields,
            tuple(a.to(**to).contiguous() for a in cols))
    return args, counts.to(dev), dict(spec=spec, geom=geom, dt=dt), anchors


def kernel_compare(fp, args, counts, kw, tol, tol_j=None, repeats=1,
                   anchors=None, zshift=None, smax=0):
    """K1 or K2 against the plain version on the same inputs, over
    ``repeats`` launches of the kernel: max |diff| over max |ref| per output
    must stay within ``tol`` (``tol_j`` for the current windows, default
    ``tol``) in every launch; the violation counts must be equal.  Returns
    the errors of the worst launch per output, the violation count, the
    worst relative error of the particles and of the J windows, and the J
    error of each launch."""
    tol_j = tol if tol_j is None else tol_j
    mode = {} if zshift is None else dict(anchors=anchors, zshift=zshift)
    plain_mode = {} if zshift is None else dict(lo=anchors,
                                                zoff=smax - zshift)
    out_p = fp.binned_push_deposit_plain(*args, counts, **plain_mode, **kw)
    ndim = kw["spec"].ndim
    names = (("x", "z") if ndim == 2 else ("x", "y", "z")) + ("ux", "uy",
                                                              "uz")
    errs = {}
    j_runs = []
    for _ in range(repeats):
        out_k = fp.binned_push_deposit(*args, counts=counts, smax=smax,
                                       **mode, **kw)
        torch.cuda.synchronize()
        run = {}
        for nm, a, b in zip(names, out_k[0], out_p[0]):
            run[nm] = rel_err(a, b)
        for nm, a, b in zip(("jx", "jy", "jz"), out_k[1], out_p[1]):
            run[nm] = rel_err(a, b)
        if not torch.equal(out_k[2], out_p[2]):
            raise AssertionError("the kernel's violation counts differ from "
                                 "its plain version's")
        for nm, e in run.items():
            errs[nm] = max(errs.get(nm, e), e, key=lambda t: t[1])
        j_runs.append(max(run[nm][1] for nm in ("jx", "jy", "jz")))
    worst_p = max(errs[nm][1] for nm in names)
    worst_j = max(errs[nm][1] for nm in ("jx", "jy", "jz"))
    if worst_p > tol or worst_j > tol_j:
        raise AssertionError(f"the {ndim}D kernel disagrees with its plain "
                             f"version: {errs}")
    return errs, int(out_p[2].sum()), worst_p, worst_j, j_runs


K1_REPEATS = 5

# Sort margin of K2's branch cases: W = 32 at orders 1-3, wider than K2's
# shared box (kBox = 24 in csrc/fused_pic_2d.cu), so the box sits inside
# the window and a tile whose particles drifted apart reaches past it.  K1's
# take the main path's margin, 1: W = 16 at orders 1-2 and 24 at order 3,
# wider than its box of 12 + order cells an edge (csrc/fused_pic.cu).
BRANCH_MARGIN = {2: 8, 3: 1}


def branch_inputs(ndim, n, order, dtype, dev, seed, smax=0, anchor_off=0.0):
    """``kernel_inputs`` at BRANCH_MARGIN with every branch of K2 (ndim 2)
    or K1 (ndim 3) reached: besides the clipped particle and the empty
    (species, tile), an all-empty tile (the last, in both species); in
    every occupied row, dead slots 3 and 5 past the first dead one with
    other momenta and positions than it; in one row, dead slots with a
    weight (in 3D the first three), which deposit, so the first is copied
    by nobody; in one tile, two alive particles moved apart (2D: 6 cells up
    and down along x and z; 3D: to window coordinate off - 1.4 and off +
    tile + 1.4 on every axis, at rest, so their stencils stay in the window
    and count no violation), so the tile's reach exceeds the shared box;
    all six external particle fields of both species nonzero.  Returns what
    ``kernel_inputs`` returns and the slots of the changed dead slots."""
    args, counts, kw, anchors = kernel_inputs(
        ndim, n, order, dtype, dev, seed, smax=smax, anchor_off=anchor_off,
        margin=BRANCH_MARGIN[ndim])
    params, fields, cols = args
    spec, geom = kw["spec"], kw["geom"]
    nt, P = spec.n_tiles, spec.p_max
    cols = [c.clone() for c in cols]
    counts = counts.clone()
    iw = ndim + 3  # the weight column
    for s in range(2):
        counts[s * nt + nt - 1] = 0
        cols[iw][s * nt + nt - 1] = 0.0
    rows = torch.nonzero((counts > 0) & (counts + 6 <= P))[:, 0]
    first = counts[rows].long()
    c = 299792458.0
    cols[ndim][rows, first + 3] += 0.05 * c
    cols[ndim + 2][rows, first + 3] -= 0.03 * c
    cols[0][rows, first + 5] += 0.3 * geom.dx[0]
    cols[1][rows, first + 5] -= 0.2 * geom.dx[1]
    r0 = int(rows[len(rows) // 2])
    # 3D: three such slots, bitwise alike: a hundred coincident ones would
    # add one ulp of their common x_new coherently (2.0e-4 of the largest
    # J value on the card, the first design's K1 alike)
    heavy = P if ndim == 2 else int(counts[r0]) + 3
    cols[iw][r0, int(counts[r0]):heavy] = 1e10
    # a tile whose particles drifted apart: not the clipped particle's
    wt = int(rows[-1]) % nt
    if wt == int(rows[0]) % nt or int(counts[wt]) < 2:
        raise AssertionError("the branch layout has no tile to spread")
    if ndim == 2:
        for slot, sign in ((0, 1.0), (1, -1.0)):
            cols[0][wt, slot] += sign * 6 * geom.dx[0]
            cols[1][wt, slot] -= sign * 6 * geom.dx[1]
    else:
        tix = []
        for d in range(3):
            stride = int(np.prod(spec.tiles_per_dim[d + 1:]))
            tix.append(wt // stride % spec.tiles_per_dim[d])
        for slot, xwin in ((0, spec.off - 1.4), (1, spec.off + 1.4)):
            for d in range(3):
                x = xwin + (spec.tile[d] if slot else 0)
                cols[d][wt, slot] = anchors[d] + (
                    tix[d] * spec.tile[d] - spec.off + x) * geom.dx[d]
                cols[3 + d][wt, slot] = 0.0
    params = params.clone()
    params[:, 2:8] = torch.tensor([1e9, -2e9, 3e9, 5.0, -3.0, 2.0],
                                  dtype=params.dtype, device=params.device)
    changed = (rows, first)
    return (params, fields, tuple(cols)), counts, kw, anchors, changed


def branch_cases(ndim, dev, repeats, smax=0, zshift=None):
    """K2 (ndim 2, 32^2) or K1 (ndim 3, 16^3) against its plain version on
    ``branch_inputs``: float64 and float32, the modes 'f32', 'mixed' and
    'bf16', orders 1-3, Galerkin on and off, Boris; ``repeats`` launches a
    case.  Tolerances as in k1_parity, k2_parity and k1d_parity, but float32
    J at TOL_J_MAIN or more.  The tiles that took the kernel's checked path
    must be > 0 in every case; the changed dead slots must come out unlike
    the first dead slot of their row.  Returns the cases."""
    from warpx_tpu_torch.ops import fused_pic as fp

    cases = []
    for dtype in (torch.float64, torch.float32):
        for mxu in ("f32", "mixed", "bf16"):
            tol = ({"particles": TOL[dtype], "j": TOL[dtype]}
                   if dtype == torch.float64 or mxu == "f32"
                   else dict(TOL_MXU[mxu]))
            if dtype == torch.float32:
                # window coordinates reach past 16 cells (2D: W = 32; 3D at
                # order 3: W = 24), where an ulp of x_new is 2^-19 cells as
                # at the main paths' W = 24
                tol["j"] = max(tol["j"], TOL_J_MAIN)
            for order in (1, 2, 3):
                for galerkin in (True, False):
                    args, counts, kw, anchors, (rows, first) = branch_inputs(
                        ndim, 32 if ndim == 2 else 16, order, dtype, dev,
                        seed=10 + order, smax=smax,
                        anchor_off=0.0 if zshift is None else 0.37)
                    kw.update(order=order, galerkin=galerkin,
                              pusher_name="boris",
                              stag_items=stag_items(ndim), mxu=mxu)
                    wide0 = fp.wide_tiles(dev, ndim)
                    _, nviol, worst_p, worst_j, _ = kernel_compare(
                        fp, args, counts, kw, tol["particles"], tol["j"],
                        repeats=repeats, anchors=anchors, zshift=zshift,
                        smax=smax)
                    wide = (fp.wide_tiles(dev, ndim) - wide0) // repeats
                    if wide < 1 or not nviol:
                        raise AssertionError(
                            f"the {ndim}D kernel's checked path ran in "
                            f"{wide} tiles, {nviol} violations")
                    out = fp.binned_push_deposit(
                        *args, counts=counts, smax=smax, **kw,
                        **({} if zshift is None else
                           dict(anchors=anchors, zshift=zshift)))[0]
                    for k in (3, 5):
                        if torch.equal(out[ndim][rows, first + k],
                                       out[ndim][rows, first]) and torch.equal(
                                out[0][rows, first + k], out[0][rows, first]):
                            raise AssertionError(
                                f"dead slot {k} past the first took its "
                                "outputs")
                    cases.append({"dtype": str(dtype), "mxu": mxu,
                                  "order": order, "galerkin": galerkin,
                                  "particles_rel_err": worst_p,
                                  "j_rel_err": worst_j, "violations": nviol,
                                  "wide_tiles": wide})
    return cases


def stag_items(ndim):
    from warpx_tpu_torch.core.grid import yee_staggering

    return tuple(sorted((k, tuple(v))
                        for k, v in yee_staggering(ndim).items()))


def phase_kernel_parity(dev, phase, ndim, n):
    """K1 (ndim 3) or K2 (ndim 2) against the plain version: both types,
    orders 1-3, three pushers, K1_REPEATS launches per case."""
    from warpx_tpu_torch.ops import fused_pic as fp

    cases = []
    for dtype in (torch.float64, torch.float32):
        for order in (1, 2, 3):
            for pusher in ("boris", "vay", "higuera"):
                args, counts, kw, _ = kernel_inputs(ndim, n, order, dtype,
                                                    dev, seed=order)
                kw.update(order=order, galerkin=True, pusher_name=pusher,
                          stag_items=stag_items(ndim))
                _, nviol, worst_p, worst_j, j_runs = kernel_compare(
                    fp, args, counts, kw, TOL[dtype], repeats=K1_REPEATS)
                if not nviol:
                    raise AssertionError("the clipped particle was not "
                                         "counted as a violation")
                cases.append({"dtype": str(dtype), "order": order,
                              "pusher": pusher, "particles_rel_err": worst_p,
                              "j_rel_err": worst_j, "j_rel_err_min": min(j_runs),
                              "violations": nviol})
    worst = {str(dt): {k: max(c[k] for c in cases if c["dtype"] == str(dt))
                       for k in ("particles_rel_err", "j_rel_err")}
             for dt in TOL}
    branches = branch_cases(ndim, dev, K1_REPEATS)
    emit(phase, ok=True, repeats=K1_REPEATS, n_cell=(n,) * ndim,
         tol=dict((str(k), v) for k, v in TOL.items()), worst=worst,
         cases=cases, branch_cases=branches)


# The precision modes in float32, kernel against plain version at 16^3 and
# 32^2: the relative error of the particles and of the J windows that
# k1d_parity allows.  'mixed' splits each deposit operand into two bfloat16
# parts, so an ulp of x_new moves its current as in 'f32' (5.8e-6 measured);
# 'bf16' rounds each operand once, and an ulp of x_new that carries an
# operand across a bfloat16 rounding boundary moves that point's value by up
# to 2^-8 of itself (8.7e-5 measured).
TOL_MXU = {"mixed": {"particles": 1e-5, "j": 1e-5},
           "bf16": {"particles": 1e-5, "j": 4e-4}}


def phase_k1d_parity(dev):
    """K1d, the precision modes 'mixed' and 'bf16' of K1 (16^3) and K2
    (32^2), against the plain version: both types, orders 1-3, three
    pushers, K1_REPEATS launches per case (1e-12 in float64, TOL_MXU in
    float32); then each mode once per kernel in moving-window mode (smax 8,
    zshift 3, tiles anchored 0.37 cells off prob_lo)."""
    from warpx_tpu_torch.ops import fused_pic as fp

    cases = []
    for ndim, n in ((3, 16), (2, 32)):
        for mxu in ("mixed", "bf16"):
            for dtype in (torch.float64, torch.float32):
                tol = ({"particles": TOL[dtype], "j": TOL[dtype]}
                       if dtype == torch.float64 else TOL_MXU[mxu])
                runs = [(order, pusher, None) for order in (1, 2, 3)
                        for pusher in ("boris", "vay", "higuera")]
                runs.append((1 if ndim == 3 else 3, "boris", 3))
                for order, pusher, zshift in runs:
                    smax = 0 if zshift is None else 8
                    args, counts, kw, anchors = kernel_inputs(
                        ndim, n, order, dtype, dev, seed=order, smax=smax,
                        anchor_off=0.0 if zshift is None else 0.37)
                    kw.update(order=order, galerkin=True, pusher_name=pusher,
                              stag_items=stag_items(ndim), mxu=mxu)
                    _, nviol, worst_p, worst_j, j_runs = kernel_compare(
                        fp, args, counts, kw, tol["particles"], tol["j"],
                        repeats=K1_REPEATS, anchors=anchors, zshift=zshift,
                        smax=smax)
                    if not nviol:
                        raise AssertionError("the clipped particle was not "
                                             "counted as a violation")
                    cases.append({"ndim": ndim, "mxu": mxu,
                                  "dtype": str(dtype), "order": order,
                                  "pusher": pusher, "zshift": zshift,
                                  "particles_rel_err": worst_p,
                                  "j_rel_err": worst_j,
                                  "j_rel_err_min": min(j_runs),
                                  "violations": nviol})
    worst = {f"{nd}d/{m}/{dt}": {
        k: max(c[k] for c in cases if (c["ndim"], c["mxu"], c["dtype"])
               == (nd, m, dt)) for k in ("particles_rel_err", "j_rel_err")}
        for nd in (3, 2) for m in ("mixed", "bf16")
        for dt in (str(torch.float64), str(torch.float32))}
    emit("k1d_parity", ok=True, repeats=K1_REPEATS,
         tol={"float64": TOL[torch.float64], "float32": TOL_MXU},
         worst=worst, cases=cases)


def phase_k1c_parity(dev):
    """The moving-window mode of K1 and K2: smax = 8 slack cells, zshift 0, 3
    and 8, tiles anchored 0.37 cells off prob_lo, against the plain versions.
    Then the mode's neutral arguments (anchors = prob_lo, zshift = 0,
    smax = 0) against the call without them: the particles and the violation
    counts must be bit-identical; the J windows are sums of shared-memory
    atomics, whose order changes from launch to launch, so they are held to
    the kernels' tolerance and their bitwise equality is only reported."""
    from warpx_tpu_torch.ops import fused_pic as fp

    smax = 8
    cases = []
    for ndim, n, order in ((3, 16, 1), (2, 32, 3)):
        for dtype in (torch.float64, torch.float32):
            for zshift in (0, 3, 8):
                args, counts, kw, anchors = kernel_inputs(
                    ndim, n, order, dtype, dev, seed=7, smax=smax,
                    anchor_off=0.37)
                kw.update(order=order, galerkin=True, pusher_name="boris",
                          stag_items=stag_items(ndim))
                _, nviol, worst_p, worst_j, _ = kernel_compare(
                    fp, args, counts, kw, TOL[dtype], anchors=anchors,
                    zshift=zshift, smax=smax)
                cases.append({"ndim": ndim, "dtype": str(dtype),
                              "zshift": zshift, "particles_rel_err": worst_p,
                              "j_rel_err": worst_j, "violations": nviol})
    neutral = []
    for ndim, n, order in ((3, 16, 1), (2, 32, 3)):
        for dtype in (torch.float64, torch.float32):
            args, counts, kw, anchors = kernel_inputs(ndim, n, order, dtype,
                                                      dev, seed=8)
            kw.update(order=order, galerkin=True, pusher_name="boris",
                      stag_items=stag_items(ndim), counts=counts)
            a = fp.binned_push_deposit(*args, **kw)
            b = fp.binned_push_deposit(*args, anchors=kw["geom"].prob_lo,
                                       zshift=0, smax=0, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(a[0] + (a[2],),
                                                         b[0] + (b[2],))):
                raise AssertionError("neutral moving-window arguments "
                                     "changed the particles")
            j_err = max(rel_err(x, y)[1] for x, y in zip(a[1], b[1]))
            if j_err > TOL[dtype]:
                raise AssertionError(f"neutral moving-window arguments "
                                     f"changed J by {j_err}")
            neutral.append({"ndim": ndim, "dtype": str(dtype),
                            "particles_bitwise": True, "j_rel_err": j_err,
                            "j_bitwise": all(torch.equal(x, y) for x, y
                                             in zip(a[1], b[1]))})
    branches = {f"{nd}d": branch_cases(nd, dev, 1, smax=smax, zshift=3)
                for nd in (3, 2)}
    emit("k1c_parity", ok=True, smax=smax,
         tol=dict((str(k), v) for k, v in TOL.items()), cases=cases,
         neutral=neutral, branch_cases=branches)


# ---- kernel K3 ------------------------------------------------------------

def phase_k3_parity(dev):
    from warpx_tpu_torch.ops.tiling import ragged_expand, ragged_expand_plain

    rng = np.random.default_rng(3)
    cases = []
    for dtype in (torch.float64, torch.float32):
        n_tiles, p_max, n_attr = 64, 128, 8
        key = np.sort(rng.integers(0, n_tiles + 1, 6000)).astype(np.int32)
        key[:700] = 5  # one tile over capacity
        key = np.sort(key)
        cap = key.size
        edges = np.searchsorted(key, np.arange(n_tiles + 1)).astype(np.int32)
        payload = torch.tensor(rng.normal(size=(n_attr, cap)), dtype=dtype,
                               device=dev)
        fill = torch.tensor(rng.normal(size=(n_attr, n_tiles)), dtype=dtype,
                            device=dev)
        offsets = torch.tensor(edges[:-1], device=dev)
        counts = torch.tensor(edges[1:] - edges[:-1], device=dev)
        got = ragged_expand(payload, offsets, counts, fill, p_max)
        ref = ragged_expand_plain(payload, offsets, counts, fill, p_max)
        if not torch.equal(got, ref):
            raise AssertionError("K3 disagrees with its plain version")
        cases.append({"dtype": str(dtype), "equal": True,
                      "empty_tiles": int((counts == 0).sum()),
                      "overfull_tiles": int((counts > p_max).sum())})
    cases += [k3_attribute_rows(dev, dtype)
              for dtype in (torch.float64, torch.float32)]
    emit("k3_parity", ok=True, cases=cases)


def k3_attribute_rows(dev, dtype):
    """K3 on a rebin's own payload with runtime attributes (Queue A 11.6):
    a 2D species of 20,000 particles with an integer attribute (values to
    2^24, exact in float32) and a real one rides as payload rows 7 and 8;
    K3 equals its plain version bit for bit, and the rebin gives the
    integer attribute back as int32 beside the same particle's real one."""
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.core.state import ParticleState
    from warpx_tpu_torch.ops import tiling

    rng = np.random.default_rng(11)
    n, lx = 20000, 40e-6
    geom = Geometry(ndim=2, n_cell=(32, 32), prob_lo=(-lx / 2,) * 2,
                    prob_hi=(lx / 2,) * 2, periodic=(True, True))
    spec = tiling.TileSpec.create(geom.n_cell, order=2, n_particles=n,
                                  margin=1, interval=1, p_max=2048)

    def t(a):
        return torch.as_tensor(a, device=dev)

    pos = rng.uniform(-lx / 2, lx / 2, (2, n))
    alive = rng.random(n) > 0.1
    roi = rng.integers(-2 ** 24, 2 ** 24 + 1, n).astype(np.int32)
    sp = ParticleState(
        x=t(pos[0]).to(dtype), z=t(pos[1]).to(dtype),
        ux=t(rng.normal(size=n)).to(dtype),
        uy=t(rng.normal(size=n)).to(dtype),
        uz=t(rng.normal(size=n)).to(dtype),
        w=t(rng.random(n) * alive).to(dtype), alive=t(alive),
        extra={"roi": t(roi), "energy": t(rng.normal(size=n)).to(dtype)})
    payload, offsets, counts, fill = tiling.rebin_inputs(sp, geom, spec)
    got = tiling.ragged_expand(payload, offsets, counts, fill, spec.p_max)
    ref = tiling.ragged_expand_plain(payload, offsets, counts, fill,
                                     spec.p_max)
    if payload.shape[0] != 2 + 5 + 2 or not torch.equal(got, ref):
        raise AssertionError(f"K3 with attribute rows disagrees "
                             f"({payload.shape[0]} rows)")
    new, ovf = tiling.rebin(sp, geom, spec)
    keep = new.alive
    # each particle by its real attribute, which the rebin copies exactly
    # (its position it wraps into the box, in the particles' type)
    back = dict(zip(new.extra["energy"][keep].tolist(),
                    new.extra["roi"][keep].tolist()))
    want = dict(zip(sp.extra["energy"][sp.alive].tolist(),
                    sp.extra["roi"][sp.alive].tolist()))
    if int(ovf) or new.extra["roi"].dtype != torch.int32 or back != want:
        raise AssertionError("the rebin lost an integer attribute")
    return {"dtype": str(dtype), "equal": True, "rows": payload.shape[0],
            "attributes": sorted(sp.extra), "alive": int(keep.sum())}


# ---- the slice on the card against the CPU --------------------------------

def checksums_agree(got, ref, tol, what):
    """The worst relative difference of every checksum but divE/divB
    (roundoff noise; test_binned.py excludes them too); raises above
    ``tol``."""
    worst = 0.0
    for group in ref:
        for q, a in ref[group].items():
            if q in ("divE", "divB"):
                continue
            r = abs(got[group][q] - a) / abs(a) if a else abs(got[group][q])
            worst = max(worst, r)
            if r > tol:
                raise AssertionError(f"{what} checksum {group}/{q}: "
                                     f"{got[group][q]!r} vs {a!r}")
    return worst


def slice_cfg(ndim):
    """slice_parity's configuration: small_cfg, the 3D one cut to 4 steps
    (a rebin at 0 and 3; 8 until the script needed the time for later
    phases)."""
    cfg = small_cfg(ndim)
    return dataclasses.replace(cfg, max_step=4) if ndim == 3 else cfg


def phase_slice_parity(dev, phase, ndim):
    import warpx_tpu_torch

    sums = {}
    for device in (dev, "cpu"):
        sim = warpx_tpu_torch.Simulation(slice_cfg(ndim),
                                         dtype=torch.float64, device=device)
        sim.init()
        sim.evolve()
        sums[str(device)] = sim.checksums()
    worst = checksums_agree(sums[str(dev)], sums["cpu"], 1e-9,
                            f"{phase} card vs CPU")
    emit(phase, ok=True, ndim=ndim, max_rel_err=worst, tol=1e-9)


# ---- the main path --------------------------------------------------------

PROFILED_STEPS = 3
# The per-particle steps launch thousands of kernels each (~12,500 at 32^2,
# the hybrid advance ~11,400), and reading their trace back takes seconds a
# step: those paths profile one step.
PROFILED_STEPS_PER_PARTICLE = 1


def profile_steps(sim, steps, top=15):
    """Device time by kernel over ``steps`` steps of the main path (from
    torch.profiler), per step, and the device's busy share of the wall
    time of those steps.  The profiler traces the device alone: recording
    every host operator too doubles the time a per-particle step's trace
    takes to read back and stretches the wall time it divides by."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        sim.evolve(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue  # operator rows repeat their kernels' device time
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3 / steps, evt.count // steps, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return {"wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy,
            "device_busy_share": busy * steps / wall_ms if wall_ms else 0.0,
            "top": [{"ms_per_step": ms, "calls_per_step": n, "name": k[:80]}
                    for ms, n, k in rows[:top]]}


def plasma_cfg(ndim, n, ppc, order, u_th, second, max_step, **kw):
    """bench.py::_build_sim's uniform thermal plasma at n^ndim cells in a
    40 um box: electrons and a second species of the electron's mass and
    opposite charge, ``ppc`` particles per cell each, Yee, dt at 0.999 of
    the Courant limit; ``kw`` sets the tiling."""
    from warpx_tpu_torch.core.config import SimConfig, SpeciesConfig
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    lx = 40e-6
    geom = Geometry(ndim=ndim, n_cell=(n,) * ndim, prob_lo=(-lx / 2,) * ndim,
                    prob_hi=(lx / 2,) * ndim, periodic=(True,) * ndim)
    species = tuple(
        SpeciesConfig(
            name=nm, charge=q, mass=9.1093837015e-31,
            injection_style="nuniformpercell",
            num_particles_per_cell_each_dim=ppc,
            profile="constant", density=2.0e24,
            momentum_distribution="gaussian",
            ux_th=u_th, uy_th=u_th, uz_th=u_th,
        )
        for nm, q in (("electrons", -1.602176634e-19),
                      (second, 1.602176634e-19))
    )
    return SimConfig(geometry=geom, max_step=max_step,
                     dt=compute_dt_yee(geom, 0.999), particle_shape=order,
                     species=species, tiled_particles="on", **kw)


def small_cfg(ndim):
    """test_binned.py's order-1 configurations: 16^3 or 32^2, 8 steps."""
    return plasma_cfg(ndim, 16 if ndim == 3 else 32, (2, 1, 1), 1, 0.1,
                      "positrons", 8, sort_interval=3)


def main_cfg(n=128, steps=25):
    """uniform-128, the 3D main path: bench.py::_build_sim at n = 128,
    ppc = 2, order 1, with the f32 deposit and gather (tile_mxu='f32')."""
    return plasma_cfg(3, n, (2, 1, 1), 1, 0.01, "ions", steps,
                      sort_interval=60, sort_margin=1, tile_headroom=1.125,
                      tile_mxu="f32")


def main2d_cfg(n=2048, steps=38):
    """uniform2d-2048, the 2D main path: the same plasma in the XZ plane at
    2048^2 cells, (2, 2) particles per cell each, with the shape order (3)
    and the sort interval (16) of bench.py::run_lwfa's deck."""
    return plasma_cfg(2, n, (2, 2), 3, 0.01, "ions", steps,
                      sort_interval=16, sort_margin=1, tile_headroom=1.125,
                      tile_mxu="f32")


# Floating-point operations of one call of each pusher in
# csrc/fused_pic_common.cuh, counted term by term (an add, a multiply, a
# divide and a square root are one each; inv_gamma is 9)
PUSH_FLOPS = {"boris": 64, "vay": 99, "higuera": 95}
# ... and of the order + 1 non-zero values of spline() a particle has at
# orders 1-3 (order 2: one inner branch of 2 and two outer of 3; order 3: two
# inner of 5 and two outer of 4); a value outside the support costs none
SPLINE_SET_FLOPS = {1: 2, 2: 8, 3: 18}


def fused_flops(order, galerkin, ndim, pusher, mxu="f32"):
    """Floating-point operations of K1 (ndim 3) or K2 (ndim 2) for one slot,
    counted from the loops of csrc/fused_pic.cu and csrc/fused_pic_2d.cu as
    (what every slot of an occupied tile needs: coordinates, gather, push;
    what only an alive slot needs: the Esirkepov weights and the deposit).
    The kernels' tails for a stencil clipped at the window's low side are
    left out: on a path with zero violations no alive particle takes them.
    In the precision modes a conversion to or from bfloat16 is not counted
    (it is no arithmetic): the gather's count is unchanged, and a deposit
    product becomes dot3x's seven operations in 'mixed' (two remainders,
    three products, two adds); in 3D 'bf16' adds one per point (two
    products where 'f32' has one) and two per row (the two scaled rows).
    K1 computes each axis's two gather weight sets once; its deposit
    counts the ``order`` rows along the deposit axis that every alive
    particle visits (one that crosses a cell face visits one more)."""
    from warpx_tpu_torch.core.grid import yee_staggering
    from warpx_tpu_torch.ops.fused_pic import _gather_table

    nt = order + 3
    gorder, gstag = _gather_table(order, galerkin, yee_staggering(ndim), ndim)

    def weights(o):  # gather_weights(): rounding add, offsets, splines
        return 2 if o == 0 else (o % 2 == 0) + (o + 1) + SPLINE_SET_FLOPS[o]

    every = 3 * ndim  # X = (pos - lo) * inv_dx - worig
    if ndim == 3:  # per axis the nodal set, X - 1/2 and the staggered set
        every += 3 * (weights(order) + 1 + weights(order - bool(galerkin)))
    for c in range(6):
        o = gorder[c * ndim:(c + 1) * ndim]
        taps = int(np.prod([v + 1 for v in o]))
        if ndim == 2:
            every += sum(gstag[c * ndim:(c + 1) * ndim])  # X - 1/2
            every += sum(weights(v) for v in o)
        # per tap a multiply-add (3D: and the product of two weights), per x
        # row a multiply-add, then the external field
        every += (ndim * taps) + 2 * (o[0] + 1) + 1
    # the pusher, 1 / gamma again, the velocities, pos + v * dt
    every += PUSH_FLOPS[pusher] + 9 + 3 + 2 * ndim
    if ndim == 3:
        # X, 1 / gamma and the velocities again, x_new; per axis the old
        # and new weight sets and per spanned row sm, df and the running
        # sum; wq; per component its scale, per row cs * scale, per point
        # seven
        nu = order + 2
        point = {"f32": 7, "mixed": 13, "bf16": 8}[mxu]
        row = 1 + (2 if mxu == "bf16" else 0)
        alive = (9 + 9 + 3 + 6 + 3 * (2 * weights(order) + 3 * nu) + 1
                 + 3 * (1 + order * (row + nu * nu * point)))
    else:
        # per axis: x_new (2), its rounding add at order 2, and per stencil
        # row two offsets, sm, df and the running sum, with both spline sets
        alive = 2 * (2 + (order % 2 == 0) + nt * 5
                     + 2 * SPLINE_SET_FLOPS[order])
        # wq, the three scales (5); per x row four factors (6); per point
        # Jx (2), Jz (2), Jy (3) and their three atomic adds; 'mixed' makes
        # each of the four products seven
        point = 10 + (24 if mxu == "mixed" else 0)
        alive += 5 + nt * 6 + nt * nt * point
    return every, alive


def ptxas_report(log):
    """ptxas's -v report in a library's build log: {function: registers}
    for the kernels and {function: spill bytes (stores and loads)} for every
    function, device functions included."""
    import re

    regs, spills = {}, {}
    fn = entry = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
        if "spill stores" in ln and fn is not None:
            spills[fn] = sum(int(v) for v in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", ln))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry is not None:
            regs[entry] = int(m.group(1))
    return regs, spills


def fused_resources(ndim, dtype, order, mxu):
    """K1's (ndim 3) or K2's (ndim 2) kernel in precision mode ``mxu``:
    registers a thread and spill bytes (stores and loads) from ptxas's
    report in its library's build log, resident blocks per SM from the CUDA
    occupancy calculator."""
    from warpx_tpu_torch import build
    from warpx_tpu_torch.ops import fused_pic as fp

    lib = fp._library_name(ndim, dtype, order)
    want = "{}_kernelI{}Li{}ELi{}E".format(
        "fused_pic" if ndim == 3 else "fused_pic_2d",
        "d" if dtype == torch.float64 else "f", order, fp.MXU_MODES[mxu])
    regs, spills = ptxas_report(build.build_log(lib))
    kern = [nm for nm in regs if want in nm]
    if len(kern) != 1 or kern[0] not in spills:
        raise AssertionError(f"no ptxas report for {want} in {lib}'s log")
    return {"registers": regs[kern[0]], "spills": spills[kern[0]],
            "blocks_per_sm": fp.blocks_per_sm(ndim, dtype, order, mxu)}


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _counter(obj, key, value=None):
    """Read a launch counter (an attribute, or an entry of a dict such as
    ``binned_push_deposit.launches_by_mode``), or set it to ``value``."""
    if value is None:
        return obj[key] if isinstance(obj, dict) else getattr(obj, key)
    if isinstance(obj, dict):
        obj[key] = value
    else:
        setattr(obj, key, value)
    return value


def run_main_path(dev, smi, phase, cfg, n_particles, steps, counters):
    """Drive one main path through Simulation: init, a warm step, ``steps``
    timed steps, PROFILED_STEPS profiled steps and the closing step, with
    the launch counters in ``counters`` (name -> (object, attribute or
    key)) set to 0 just before and read just after.  Checks the result (zero overflow
    and violations, every particle alive, weight conserved, finite fields
    of the grid's shape) and emits the phase's line and its profile.
    Returns (sim, launches)."""
    import warpx_tpu_torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    if not sim.binned:
        raise AssertionError(f"the {phase} path did not take the tile-binned "
                             "step")
    for obj, attr in counters.values():
        _counter(obj, attr, 0)
    sim.init()
    sim.evolve(1)  # warm step: rebins (K3) and the first fused launch
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the timed window, with an event after every step: the window's time
    # is first to last event, the series shows how the step's cost moves
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    marks[0].record()
    for mark in marks[1:]:
        sim.evolve(1)
        mark.record()
    marks[-1].synchronize()
    ms_total = marks[0].elapsed_time(marks[-1])
    series = [round(a.elapsed_time(b), 3) for a, b in zip(marks, marks[1:])]
    breakdown = profile_steps(sim, PROFILED_STEPS)
    sim.evolve()  # the closing step, with the +dt/2 synchronization
    torch.cuda.synchronize()
    launches = {nm: _counter(obj, attr)
                for nm, (obj, attr) in counters.items()}
    peak_steps = torch.cuda.max_memory_allocated()
    # one more step from the state the run ended in, not kept: the step's
    # time under the conditions the kernels are timed in below
    ms_final = cuda_ms(lambda: sim.step(sim.state), 5)
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the {phase} path never ran: "
                             f"{launches}")
    spec = sim.tile_spec
    geom = cfg.geometry
    stepped = sim.state
    sums = sim.checksums()  # raises on tile overflow or violations
    for group in sums.values():
        for q, v in group.items():
            if not np.isfinite(v):
                raise AssertionError(f"non-finite checksum {q}")
    alive = sum(int(sp.alive.sum()) for sp in sim.state.species.values())
    if alive != n_particles:
        raise AssertionError(f"{alive} alive particles of {n_particles}")
    for sp_cfg in cfg.species:
        # a uniform species' weights sum to density * volume
        total_w = sp_cfg.density * geom.cell_volume * np.prod(geom.n_cell)
        w_rel = abs(sums[sp_cfg.name]["particle_weight"] / total_w - 1)
        if w_rel > 1e-5:
            raise AssertionError(f"{sp_cfg.name} weight drifted by {w_rel}")
    for f in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz"):
        a = getattr(sim.state.fields, f)
        if (tuple(a.shape) != tuple(geom.n_cell)
                or not bool(torch.isfinite(a).all())):
            raise AssertionError(f"field {f} is not finite at {geom.n_cell}")
    ms_step = ms_total / steps
    emit(phase, ok=True, n_cell=geom.n_cell, n_particles=n_particles,
         order=cfg.particle_shape, tile_mxu=cfg.tile_mxu,
         n_tiles=spec.n_tiles, w=spec.w,
         p_max=spec.p_max, steps_timed=steps, ms_per_step=ms_step,
         pushes_per_s=n_particles / (ms_step * 1e-3), init_s=init_s,
         launches=launches, tile_overflow=0, tile_violations=0,
         ms_per_step_final_state=ms_final, ms_each_step=series,
         peak_memory_bytes={"steps": peak_steps, "with_checksums":
                            torch.cuda.max_memory_allocated()},
         checksum_Ex=sums["lev=0"]["Ex"], checksum_jx=sums["lev=0"]["jx"],
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    emit(phase + "_profile", steps=PROFILED_STEPS, **breakdown)
    # checksums() wrapped the positions; the kernels are timed on the state
    # the next step would give them
    sim.state = stepped
    return sim, launches


def fused_at_main_shapes(sim, plain_reps, window=None, mxu="f32"):
    """K1 or K2 on the state ``sim`` ended in, against the plain version:
    errors, times, bytes (each input read once, each output written once),
    operations (``fused_flops``: gather and push for every slot of an
    occupied tile, weights and deposit for the alive slots) and the bound.
    ``window`` = (fields6, pusher params, anchors, zshift, smax) runs the
    kernel in moving-window mode on the bounded step's inputs; ``mxu`` is
    the precision mode, and a mode other than 'f32' is timed beside the
    kernel at 'f32' on the same inputs.  The row adds the kernel's
    registers, spills and resident blocks per SM (``fused_resources``), the
    tiles of one launch that took its checked path and the tiles with an
    alive particle.  Returns the kernels-line fields that are measured
    here."""
    from warpx_tpu_torch.core.binned_step import pusher_groups
    from warpx_tpu_torch.ops import fused_pic as fp

    cfg, spec, state = sim.cfg, sim.tile_spec, sim.state
    mode, plain_mode, group_params = {}, {}, sim.params
    if window is None:
        farr = state.fields
        fields6 = fp.pad_fields((farr.Ex, farr.Ey, farr.Ez, farr.Bx, farr.By,
                                 farr.Bz), spec)
    else:
        fields6, group_params, anchors, zshift, smax = window
        mode = dict(anchors=anchors, zshift=zshift, smax=smax)
        plain_mode = dict(lo=anchors, zoff=smax - zshift)
    ((pname, _, params, parts, counts),) = list(
        pusher_groups(state, spec, group_params))
    kw = dict(spec=spec, geom=cfg.geometry, order=cfg.particle_shape,
              galerkin=cfg.galerkin, pusher_name=pname, dt=cfg.dt,
              stag_items=stag_items(spec.ndim), mxu=mxu)
    args = (params, fields6, parts)
    tol_j = (TOL_J_BF16 if mxu == "bf16"
             else TOL_J_MAIN if window is None else TOL_J_WINDOW)
    errs, _, worst_p, worst_j, _ = kernel_compare(
        fp, args, counts, kw, TOL[torch.float32], tol_j,
        anchors=mode.get("anchors"), zshift=mode.get("zshift"),
        smax=mode.get("smax", 0))

    def launch():
        return fp.binned_push_deposit(*args, counts=counts, **mode, **kw)

    ms = cuda_ms(launch, 10)
    f32_ms = None
    if mxu != "f32":
        f32_ms = cuda_ms(lambda: fp.binned_push_deposit(
            *args, counts=counts, **mode, **{**kw, "mxu": "f32"}), 10)
    plain_ms = cuda_ms(lambda: fp.binned_push_deposit_plain(
        *args, counts, **plain_mode, **kw), plain_reps)
    dev = parts[0].device
    wide0 = fp.wide_tiles(dev, spec.ndim)
    out = launch()
    n_bytes = (nbytes(params, counts, *fields6, *parts)
               + nbytes(*out[0], *out[1], out[2]))
    every, alive = fused_flops(cfg.particle_shape, cfg.galerkin, spec.ndim,
                               pname, mxu)
    flops = (int((counts > 0).sum()) * spec.p_max * every
             + int(counts.sum()) * alive)
    tb = n_bytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / PEAK_FLOPS[torch.float32] * 1e3
    row = {"max_abs_err": max(a for a, _ in errs.values()),
           "max_rel_err": {"particles": worst_p, "j": worst_j},
           "tol_rel": {"particles": TOL[torch.float32], "j": tol_j},
           "ms": ms, "f32_ms": f32_ms, "plain_ms": plain_ms,
           "bound_ms": max(tb, tf),
           "bound_by": "bytes" if tb >= tf else "operations",
           "bytes": n_bytes, "flops": flops,
           "flops_per_slot": {"every": every, "alive": alive},
           "library_ms": None}
    row.update(fused_resources(spec.ndim, torch.float32, cfg.particle_shape,
                               mxu),
               wide_tiles=fp.wide_tiles(dev, spec.ndim) - wide0,
               occupied_tiles=int((counts.reshape(
                   -1, spec.n_tiles) > 0).any(0).sum()))
    return row


def k3_at_main_shapes(sim, origin=None, wrap_dims=None):
    """K3 on the electrons of the state ``sim`` ended in, against the plain
    version (exactly), with its times, bytes and bound; ``origin`` and
    ``wrap_dims`` as the bounded step gives them to the rebin."""
    from warpx_tpu_torch.ops import tiling

    spec = sim.tile_spec
    k3_in = tiling.rebin_inputs(sim.state.species["electrons"],
                                sim.cfg.geometry, spec, origin=origin,
                                wrap_dims=wrap_dims)
    got = tiling.ragged_expand(*k3_in, spec.p_max)
    ref = tiling.ragged_expand_plain(*k3_in, spec.p_max)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("K3 disagrees with its plain version at the "
                             "main path's shapes")
    del ref
    ms = cuda_ms(lambda: tiling.ragged_expand(*k3_in, spec.p_max), 10)
    plain_ms = cuda_ms(lambda: tiling.ragged_expand_plain(
        *k3_in, spec.p_max), 3)
    payload, offsets, counts, fill = k3_in
    kept = int(torch.clamp(counts, max=spec.p_max).sum())
    n_bytes = (payload.shape[0] * kept * payload.element_size()
               + nbytes(offsets, counts, fill, got))
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": n_bytes / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes": n_bytes, "library_ms": None}


def phase_main(dev, smi, n=128):
    """uniform-128 through K1 and K3; returns their kernels-line rows."""
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling

    sim, launches = run_main_path(
        dev, smi, "main", main_cfg(n), 2 * 2 * n ** 3, 20,
        {"fused_pic": (fp.binned_push_deposit, "launches"),
         "ragged_expand": (tiling.ragged_expand, "launches")})
    k1 = fused_at_main_shapes(sim, 2)
    k3 = k3_at_main_shapes(sim)
    return ({"name": "fused_pic", "route": "cuda",
             "source": "warpx_tpu_torch/csrc/fused_pic.cu",
             "replaces": "warpx_tpu/ops/pallas_pic.py:116",
             "launches": launches["fused_pic"], **k1},
            {"name": "ragged_expand", "route": "cuda",
             "source": "warpx_tpu_torch/csrc/ragged_expand.cu",
             "replaces": "warpx_tpu/ops/tiling.py:142",
             "launches": launches["ragged_expand"],
             "launches_by_path": {"main": launches["ragged_expand"]}, **k3})


def phase_main_mixed(dev, smi, k3_row, n=128):
    """uniform-128 at tile_mxu = 'mixed', bench.py's default for this
    workload, driven as ``main`` drives it; then the same at 'bf16', which
    bench.py measures beside 'f32'.  After each, K1 in that mode at
    the main path's shapes against its plain version, timed beside K1 at
    'f32' on the same inputs and beside its bound.  Returns the two
    kernels-line rows and adds these paths' K3 launches to ``k3_row``."""
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling

    by_mode = fp.binned_push_deposit.launches_by_mode
    rows = []
    for mxu in ("mixed", "bf16"):
        phase = f"main_{mxu}"
        by_mode["f32"] = 0
        sim, launches = run_main_path(
            dev, smi, phase, dataclasses.replace(main_cfg(n), tile_mxu=mxu),
            2 * 2 * n ** 3, 20,
            {"fused_pic": (fp.binned_push_deposit, "launches"),
             f"fused_pic_{mxu}": (by_mode, mxu),
             "ragged_expand": (tiling.ragged_expand, "launches")})
        if by_mode["f32"] or launches[f"fused_pic_{mxu}"] != launches[
                "fused_pic"]:
            raise AssertionError(f"{phase} launched K1 in another mode: "
                                 f"{launches}, {by_mode}")
        k1 = fused_at_main_shapes(sim, 2, mxu=mxu)
        k3_row["launches"] += launches["ragged_expand"]
        k3_row["launches_by_path"][phase] = launches["ragged_expand"]
        rows.append({"name": f"fused_pic_{mxu}", "route": "cuda",
                     "source": "warpx_tpu_torch/csrc/fused_pic.cu",
                     "replaces": "warpx_tpu/ops/pallas_pic.py:133",
                     "mxu": mxu, "launches": launches[f"fused_pic_{mxu}"],
                     **k1})
        del sim
    return rows


def phase_main2d(dev, smi, k3_row, n=2048):
    """uniform2d-2048 through K2 and K3; returns K2's kernels-line row and
    adds this path's K3 launches and times to ``k3_row``."""
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling

    steps = 33  # after the warm step 0: rebins at steps 16 and 32
    sim, launches = run_main_path(
        dev, smi, "main2d", main2d_cfg(n), 2 * 4 * n * n, steps,
        {"fused_pic_2d": (fp.binned_push_deposit, "launches_2d"),
         "ragged_expand": (tiling.ragged_expand, "launches")})
    k2 = fused_at_main_shapes(sim, 1)
    k3 = k3_at_main_shapes(sim)
    k3_row["launches"] += launches["ragged_expand"]
    k3_row["launches_by_path"]["main2d"] = launches["ragged_expand"]
    k3_row["at_main2d"] = k3
    return {"name": "fused_pic_2d", "route": "cuda",
            "source": "warpx_tpu_torch/csrc/fused_pic_2d.cu",
            "replaces": "warpx_tpu/ops/pallas_pic.py:408",
            "launches": launches["fused_pic_2d"], **k2}


# ---- the bounded step ------------------------------------------------------

Q_E = 1.602176634e-19
M_E = 9.1093837015e-31
M_P = 1.67262192369e-27


def lwfa_cfg(n_cell, lo, hi, x_bound, zmin, beam_z, laser_z, ppc, max_step,
             interval, **kw):
    """The 2D laser-wakefield deck of bench.py (``_LWFA_2D_DECK``) and of
    tests/test_binned_bounded.py as a SimConfig, field for field: PML on the
    four faces, absorbing particle faces, moving window along z at c, current
    filter, order 3, Yee at 0.98 of the Courant limit; electrons at
    2e23 m^-3 within |x| <= ``x_bound`` above ``zmin``, continuously
    injected; a 100-particle Gaussian beam at ``beam_z``; a Gaussian laser
    antenna at ``laser_z``.  The laser's species comes last, as the deck
    reader orders it."""
    from warpx_tpu_torch.core.config import (LaserConfig, SimConfig,
                                             SpeciesConfig)
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    inf = float("inf")
    geom = Geometry(ndim=2, n_cell=tuple(n_cell), prob_lo=tuple(lo),
                    prob_hi=tuple(hi), periodic=(False, False))
    electrons = SpeciesConfig(
        name="electrons", charge=-Q_E, mass=M_E, species_type="electron",
        injection_style="nuniformpercell",
        num_particles_per_cell_each_dim=ppc, profile="constant",
        density=2.0e23, momentum_distribution="at_rest",
        bounds_lo=(-x_bound, zmin), bounds_hi=(x_bound, inf),
        do_continuous_injection=True)
    beam = SpeciesConfig(
        name="beam", charge=-Q_E, mass=M_E, species_type="electron",
        injection_style="gaussian_beam", x_rms=0.5e-6, y_rms=0.5e-6,
        z_rms=0.5e-6, x_m=0.0, y_m=0.0, z_m=beam_z, npart=100,
        q_tot=-1.0e-12, momentum_distribution="gaussian", ux=0.0, uy=0.0,
        uz=500.0, ux_th=2.0, uy_th=2.0, uz_th=50.0,
        bounds_lo=(-inf, -inf), bounds_hi=(inf, inf))
    laser = LaserConfig(
        name="laser1", profile="gaussian", position=(0.0, 0.0, laser_z),
        direction=(0.0, 0.0, 1.0), polarization=(0.0, 1.0, 0.0),
        e_max=16.0e12, profile_waist=5.0e-6, profile_duration=15.0e-15,
        profile_t_peak=30.0e-15, profile_focal_distance=100.0e-6,
        wavelength=0.8e-6)
    antenna = SpeciesConfig(name="laser1", charge=1.0, mass=0.0,
                            injection_style="laser")
    return SimConfig(
        geometry=geom, max_step=max_step, dt=compute_dt_yee(geom, 0.98),
        cfl=0.98, particle_shape=3, em_solver="yee", use_filter=True,
        filter_npass_each_dir=(1, 1), species=(electrons, beam, antenna),
        lasers=(laser,), field_bc_lo=("pml", "pml"),
        field_bc_hi=("pml", "pml"), particle_bc_lo=("absorbing",) * 2,
        particle_bc_hi=("absorbing",) * 2, do_moving_window=True,
        moving_window_dir=1, moving_window_v=1.0, sort_interval=interval,
        field_centering_no=(2, 2), tiled_particles="on", tile_mxu="f32",
        # the deck reader's amr.ref_ratio, read whatever amr.max_level is
        ref_ratio=(2, 2), **kw)


# The deck texts this script runs through Simulation.from_deck, kept as
# copies (it imports neither bench.py nor the tests, which import JAX;
# tests/test_torch_deck.py holds the copies equal): bench.py::_LWFA_2D_DECK
# and tests/test_binned_bounded.py::_LWFA_2D.
LWFA_2D_DECK = """
max_step = {max_step}
amr.n_cell = {nx} {nz}
geometry.dims = 2
geometry.prob_lo = -30.e-6 -56.e-6
geometry.prob_hi =  30.e-6  12.e-6
boundary.field_lo = pml pml
boundary.field_hi = pml pml
warpx.verbose = 0
warpx.use_filter = 1
warpx.cfl = 0.98
warpx.do_moving_window = 1
warpx.moving_window_dir = z
warpx.moving_window_v = 1.0
warpx.sort_intervals = {interval}
tpu.tiled_particles = on
tpu.tile_mxu = {mxu}
algo.particle_shape = 3
algo.maxwell_solver = yee
particles.species_names = electrons beam
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = {ppcx} {ppcz} 1
electrons.xmin = -20.e-6
electrons.xmax =  20.e-6
electrons.zmin = -56.e-6
electrons.profile = constant
electrons.density = 2.e23
electrons.momentum_distribution_type = at_rest
electrons.do_continuous_injection = 1
beam.species_type = electron
beam.injection_style = gaussian_beam
beam.x_rms = .5e-6
beam.y_rms = .5e-6
beam.z_rms = .5e-6
beam.x_m = 0.
beam.y_m = 0.
beam.z_m = -28.e-6
beam.npart = 100
beam.q_tot = -1.e-12
beam.momentum_distribution_type = gaussian
beam.ux_m = 0.0
beam.uy_m = 0.0
beam.uz_m = 500.
beam.ux_th = 2.
beam.uy_th = 2.
beam.uz_th = 50.
lasers.names = laser1
laser1.profile = Gaussian
laser1.position = 0. 0. 9.e-6
laser1.direction = 0. 0. 1.
laser1.polarization = 0. 1. 0.
laser1.e_max = 16.e12
laser1.profile_waist = 5.e-6
laser1.profile_duration = 15.e-15
laser1.profile_t_peak = 30.e-15
laser1.profile_focal_distance = 100.e-6
laser1.wavelength = 0.8e-6
"""
LWFA_32X64_DECK = """
max_step = 12
amr.n_cell = 32 64
geometry.dims = 2
geometry.prob_lo = -15.e-6 -28.e-6
geometry.prob_hi =  15.e-6   6.e-6
boundary.field_lo = pml pml
boundary.field_hi = pml pml
warpx.cfl = 0.98
warpx.use_filter = 1
warpx.do_moving_window = 1
warpx.moving_window_dir = z
warpx.moving_window_v = 1.0
warpx.sort_intervals = 4
algo.particle_shape = 3
algo.maxwell_solver = yee
particles.species_names = electrons beam
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1 1
electrons.xmin = -12.e-6
electrons.xmax =  12.e-6
electrons.zmin = -20.e-6
electrons.profile = constant
electrons.density = 2.e23
electrons.momentum_distribution_type = at_rest
electrons.do_continuous_injection = 1
beam.species_type = electron
beam.injection_style = gaussian_beam
beam.x_rms = .5e-6
beam.y_rms = .5e-6
beam.z_rms = .5e-6
beam.x_m = 0.
beam.y_m = 0.
beam.z_m = -14.e-6
beam.npart = 100
beam.q_tot = -1.e-12
beam.momentum_distribution_type = gaussian
beam.ux_m = 0.0
beam.uy_m = 0.0
beam.uz_m = 500.
beam.ux_th = 2.
beam.uy_th = 2.
beam.uz_th = 50.
lasers.names = laser1
laser1.profile = Gaussian
laser1.position = 0. 0. -10.e-6
laser1.direction = 0. 0. 1.
laser1.polarization = 0. 1. 0.
laser1.e_max = 16.e12
laser1.profile_waist = 5.e-6
laser1.profile_duration = 15.e-15
laser1.profile_t_peak = 30.e-15
laser1.profile_focal_distance = 100.e-6
laser1.wavelength = 0.8e-6
"""


def small_lwfa_cfg():
    """tests/test_binned_bounded.py's 32 x 64 deck, 12 steps."""
    return lwfa_cfg((32, 64), (-15e-6, -28e-6), (15e-6, 6e-6), 12e-6, -20e-6,
                    -14e-6, -10e-6, (1, 1, 1), 12, 4)


def main_lwfa_cfg(nx=2048, nz=8192, steps=95):
    """lwfa2d-2048x8192: bench.py::run_lwfa's deck (60 um x 68 um window,
    the plasma filling it from its lower edge, 2 x 2 per cell, sort interval
    16) with tile_mxu='f32'."""
    return lwfa_cfg((nx, nz), (-30e-6, -56e-6), (30e-6, 12e-6), 20e-6,
                    -56e-6, -28e-6, 9e-6, (2, 2, 1), steps, 16)


def pec3d_cfg():
    """tests/test_binned_bounded.py's 16^3 deck: periodic in x and y, PEC
    walls and reflecting particles along z, thermal electrons and protons
    at rest, order 2, current filter, 5 steps (rebins at 0 and 4; 8 until
    the script needed the time for later phases); with three particles per
    cell instead of one, because a species of at most 8192 particles keeps
    its compact layout and would never reach K1."""
    from warpx_tpu_torch.core.config import SimConfig, SpeciesConfig
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    geom = Geometry(ndim=3, n_cell=(16,) * 3, prob_lo=(-8e-6,) * 3,
                    prob_hi=(8e-6,) * 3, periodic=(True, True, False))
    common = dict(injection_style="nuniformpercell",
                  num_particles_per_cell_each_dim=(1, 1, 3),
                  profile="constant", density=1.0e24)
    species = (
        SpeciesConfig(name="electrons", charge=-Q_E, mass=M_E,
                      species_type="electron",
                      momentum_distribution="gaussian", ux_th=0.05,
                      uy_th=0.05, uz_th=0.05, **common),
        SpeciesConfig(name="protons", charge=Q_E, mass=M_P,
                      species_type="proton",
                      momentum_distribution="at_rest", **common))
    return SimConfig(
        geometry=geom, max_step=5, dt=compute_dt_yee(geom, 0.98), cfl=0.98,
        particle_shape=2, use_filter=True, filter_npass_each_dir=(1, 1, 1),
        species=species, field_bc_lo=("periodic", "periodic", "pec"),
        field_bc_hi=("periodic", "periodic", "pec"),
        particle_bc_lo=("periodic", "periodic", "reflecting"),
        particle_bc_hi=("periodic", "periodic", "reflecting"),
        tiled_particles="on")


def phase_bounded_parity(dev):
    """The bounded tile-binned step on the card (kernels) against the same
    run on the CPU (plain versions), float64: every checksum but divE/divB
    within 1e-9, no overflow or violation, the window moved, and the fused
    kernel was launched once per step, so that a fall to the per-particle
    step fails."""
    import warpx_tpu_torch
    from warpx_tpu_torch.ops import fused_pic as fp

    cases = []
    for name, cfg, counter in (("lwfa_32x64", small_lwfa_cfg(), "launches_2d"),
                               ("pec_16^3", pec3d_cfg(), "launches")):
        sums = {}
        before = getattr(fp.binned_push_deposit, counter)
        for device in (dev, "cpu"):
            sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64,
                                             device=device)
            if not (sim.is_bounded and sim.binned):
                raise AssertionError(f"{name} did not take the bounded "
                                     "tile-binned step")
            sim.init()
            sim.evolve()
            sums[str(device)] = sim.checksums()  # raises on overflow etc.
            if device is dev:
                aux = sim.state.aux
                zshifts = sorted(sim.stepper.zshifts_seen)
        grew = getattr(fp.binned_push_deposit, counter) - before
        if grew != cfg.max_step:
            raise AssertionError(f"{name}: {grew} fused launches in "
                                 f"{cfg.max_step} steps")
        if cfg.do_moving_window and not (
                aux["window_offset"] > 0
                and aux["window_lo"] > cfg.geometry.prob_lo[1]):
            raise AssertionError(f"{name}: the window did not move")
        worst = checksums_agree(sums[str(dev)], sums["cpu"], 1e-9,
                                f"{name} card vs CPU")
        cases.append({"case": name, "steps": cfg.max_step,
                      "fused_launches": grew, "max_rel_err": worst,
                      "window_offset": int(aux.get("window_offset", 0)),
                      "zshifts_seen": zshifts})
    emit("bounded_parity", ok=True, tol=1e-9, cases=cases)


def quiet_step(s0, interval):
    """Whether the bounded binned step from step ``s0`` neither rebins (it
    does when ``s0`` is a multiple of the sort interval) nor injects (at the
    end of the step before a rebin)."""
    return bool(s0 % interval and (s0 + 1) % interval)


def count_device_waits(fn):
    """The number of times ``fn()`` makes the host wait for the device, from
    PyTorch's own warnings (torch.cuda.set_sync_debug_mode)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def lwfa_layers(sim, anchors, zshift):
    """Device milliseconds of the bounded step's layers, each called alone
    on the state the run ended in (a step without rebin or injection), and
    of the whole step there."""
    from warpx_tpu_torch.core.binned_step import pusher_groups
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling
    from warpx_tpu_torch.solvers.filter import bilinear_filter_padded

    stepper, spec, cfg, state = sim.stepper, sim.tile_spec, sim.cfg, sim.state
    geom, fields = cfg.geometry, state.fields
    fields6 = stepper.to_kernel_frame(stepper._padded_eb(fields))
    ((pname, _, params, parts, counts),) = list(
        pusher_groups(state, spec, stepper.params))
    _, jw, _ = fp.binned_push_deposit(
        params, fields6, parts, anchors, zshift, counts=counts, spec=spec,
        geom=geom, order=cfg.particle_shape, galerkin=cfg.galerkin,
        pusher_name=pname, dt=cfg.dt, stag_items=stepper.stag_items,
        smax=stepper.smax)
    del fields6, parts

    def fold():
        return tuple(stepper.embed_folded(
            tiling.fold_windows_open(jw[i], spec), zshift) for i in range(3))

    j_total = fold()
    npass = cfg.filter_npass_each_dir
    el = state.species["electrons"]
    return {
        "pad_eb_and_kernel_frame": cuda_ms(
            lambda: stepper.to_kernel_frame(stepper._padded_eb(fields)), 5),
        "pack_species_columns": cuda_ms(
            lambda: list(pusher_groups(state, spec, stepper.params)), 5),
        "fold_windows_open_and_embed": cuda_ms(fold, 5),
        "filter_j": cuda_ms(
            lambda: [bilinear_filter_padded(a, npass) for a in j_total], 5),
        "field_tail_filter_included": cuda_ms(
            lambda: stepper.field_tail(state, state.species, j_total, {}), 5),
        "step_window_shift_and_faces": cuda_ms(
            lambda: stepper.step_window(state, False), 5),
        "rebin_electrons": cuda_ms(
            lambda: tiling.rebin(el, geom, spec, origin=anchors,
                                 wrap_dims=stepper.wrap_dims), 3),
        "continuous_injection": cuda_ms(
            lambda: stepper.continuous_injection(
                state, cfg.species[0], el, stepper.phys_lo_of(state),
                stepper.domain_hi_of(state)), 3),
        "step_binned": cuda_ms(lambda: stepper.step(state), 5),
    }


# main_lwfa's and main_lwfa_deck's 30 steps (54, warm and counted 16,
# until the script needed the time for later phases); the boosted run keeps
# the 54 its band of lab times was laid out for
LWFA_PLAN = dict(warm=4, timed=16, counted=4, interval=16)
LWFA_BOOSTED_PLAN = dict(warm=16, timed=16, counted=16, interval=16)


def lwfa_steps(plan):
    """The steps a laser-wakefield phase runs: warm, timed, counted, one
    rebin step, the profiled steps and two closing steps."""
    return (plan["warm"] + plan["timed"] + plan["counted"] + 1
            + PROFILED_STEPS + 2)


def run_lwfa_path(dev, smi, phase, sim, plan, boosted=False, on_init=None):
    """Drive the bounded laser-wakefield path ``sim`` (built, not yet
    initialised): init, ``warm`` steps (two rebins, the window moving),
    ``timed`` steps with an event after each, ``counted`` steps with the
    host's waits for the device counted, a rebin step, PROFILED_STEPS
    profiled steps and the closing steps, with the launch counters of K2
    (in ``cfg.tile_mxu``, and in no other mode) and K3 set to 0 just before
    and read just after.  Checks the result (zero overflow and violations,
    finite fields of the block's shapes, the window moved, the alive
    electrons explained by the rows absorbed and injected) and emits the
    phase's line and its profile.  Returns (launches, anchors, zshift,
    waits): the tiling anchor and the window's slide the next step would
    give K2, and the counted steps' waits for the device (``idle``: the set
    of counts of the steps that neither rebin nor inject).  ``boosted``: a
    Lorentz-boosted run, whose window slides a fraction of a cell a step
    (zshift takes a few values) and whose plasma streams away from the
    window's lower edge: the alive electrons are the initial ones and the
    rows injected at the top row's density.  ``on_init(sim)`` runs just
    after the init; ``waits`` also holds the timed steps' ``ms_per_step``."""
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling

    cfg = sim.cfg
    geom = cfg.geometry
    steps = lwfa_steps(plan)
    if cfg.max_step != steps:
        raise AssertionError(f"{phase}: max_step {cfg.max_step} for {steps} "
                             "steps")
    if not (sim.is_bounded and sim.binned):
        raise AssertionError(f"{phase} did not take the bounded tile-binned "
                             "step")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    by_mode = fp.binned_push_deposit.launches_by_mode
    for k in by_mode:
        by_mode[k] = 0
    fp.binned_push_deposit.launches_2d = 0
    tiling.ragged_expand.launches = 0
    sim.init()
    if on_init is not None:
        on_init(sim)
    spec, stepper = sim.tile_spec, sim.stepper
    n0 = {nm: int(sp.alive.sum()) for nm, sp in sim.state.species.items()}
    el0 = sim.state.species["electrons"]
    # the electrons of one cell row along z (the window's top row)
    row0 = int((el0.alive & (el0.z >= geom.prob_hi[1] - geom.dx[1])).sum())
    host_init_s = time.perf_counter() - t0
    sim.evolve(plan["warm"])  # two rebins, the window moving
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    timed = plan["timed"]
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
    marks[0].record()
    for mark in marks[1:]:
        sim.evolve(1)
        mark.record()
    marks[-1].synchronize()
    ms_step = marks[0].elapsed_time(marks[-1]) / timed
    series = [round(a.elapsed_time(b), 3) for a, b in zip(marks, marks[1:])]
    first = sim.state.step
    per_step = [count_device_waits(lambda: sim.evolve(1))
                for _ in range(plan["counted"])]
    waits_by_step = {
        "ms_per_step": ms_step, "first_step": first, "per_step": per_step,
        "idle": sorted({w for i, w in enumerate(per_step)
                        if quiet_step(first + i, plan["interval"])})}
    sim.evolve(1)  # a rebin step: the profiled ones that follow have none
    breakdown = profile_steps(sim, PROFILED_STEPS, top=30)
    sim.evolve()  # the closing steps, with the +dt/2 synchronization
    torch.cuda.synchronize()
    if sim.state.step != steps:
        raise AssertionError(f"{phase} ended at step {sim.state.step}")
    launches = {"fused_pic_2d": fp.binned_push_deposit.launches_2d,
                "ragged_expand": tiling.ragged_expand.launches}
    rebins = len(range(0, steps, plan["interval"]))
    if launches != {"fused_pic_2d": steps, "ragged_expand": rebins}:
        raise AssertionError(f"{phase} launched {launches} in {steps} "
                             f"steps with {rebins} rebins")
    if by_mode != {m: (steps if m == cfg.tile_mxu else 0) for m in by_mode}:
        raise AssertionError(f"{phase} at tile_mxu={cfg.tile_mxu!r} "
                             f"launched K2 in the modes {by_mode}")
    peak_steps = torch.cuda.max_memory_allocated()
    zshifts = sorted(stepper.zshifts_seen)
    if not (zshifts[0] == 0 and zshifts[-1] < stepper.smax
            and len(zshifts) >= (2 if boosted else plan["interval"] - 1)):
        raise AssertionError(f"zshift took {zshifts} of [0, {stepper.smax})")
    stepped = sim.state
    sums = sim.checksums()  # raises on tile overflow or violations
    for group in sums.values():
        for q, v in group.items():
            if not np.isfinite(v):
                raise AssertionError(f"non-finite checksum {q}")
    for nm, shape in stepper.shapes.items():
        if nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz"):
            a = getattr(sim.state.fields, nm)
            if (tuple(a.shape) != tuple(shape)
                    or not bool(torch.isfinite(a).all())):
                raise AssertionError(f"field {nm} is not finite at {shape}")
    aux = sim.state.aux
    offset = int(aux["window_offset"])
    if offset <= 0:
        raise AssertionError("the window did not move")
    # the electrons are at rest: each cell row along z that the window left
    # behind took its particles along, each row injected brought as many
    alive = {nm: int(sp.alive.sum()) for nm, sp in sim.state.species.items()}
    per_row = n0["electrons"] / geom.n_cell[1]
    rows_in = round(float(aux["inject_pos:electrons"] - geom.prob_hi[1])
                    / geom.dx[1])
    expected = n0["electrons"] + (rows_in - offset) * per_row
    if boosted:
        # the plasma streams down at -beta c, away from the window's lower
        # edge: no row is absorbed.  The injection front rides down with
        # it and jumps to the window's top at each injection: the jumps are
        # the rows injected
        beta = (1.0 - 1.0 / cfg.gamma_boost ** 2) ** 0.5
        per_row = row0
        rows_in = (float(aux["inject_pos:electrons"]) - geom.prob_hi[1]
                   + beta * C_LIGHT * float(sim.state.time)) / geom.dx[1]
        expected = n0["electrons"] + rows_in * per_row
    if abs(alive["electrons"] - expected) > per_row:
        raise AssertionError(f"{alive['electrons']} electrons alive, "
                             f"{expected} explained by {offset} rows "
                             f"absorbed and {rows_in} injected")
    n_mean = 0.5 * (n0["electrons"] + alive["electrons"])
    emit(phase, ok=True, n_cell=geom.n_cell, tile_mxu=cfg.tile_mxu,
         field_shape=stepper.shapes["Ex"], alive_at_init=n0,
         alive_at_end=alive, electrons_expected=expected,
         rows_absorbed=offset, rows_injected=rows_in, order=cfg.particle_shape,
         n_tiles=spec.n_tiles, w=spec.w, p_max=spec.p_max,
         slots=spec.capacity, smax=stepper.smax, zshifts_seen=zshifts,
         slow_species=sorted(stepper.slow_species), steps=steps,
         steps_timed=timed, ms_per_step=ms_step,
         pushes_per_s=n_mean / (ms_step * 1e-3), ms_each_step=series,
         host_init_s=host_init_s, init_and_warm_s=init_s, launches=launches,
         launches_by_mode=dict(by_mode),
         device_waits={"steps": plan["counted"], "waits": sum(per_step),
                       **waits_by_step},
         tile_overflow=0, tile_violations=0,
         window_offset=offset,
         peak_memory_bytes={"steps": peak_steps, "with_checksums":
                            torch.cuda.max_memory_allocated()},
         checksum_Ey=sums["lev=0"]["Ey"], checksum_jz=sums["lev=0"]["jz"],
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    emit(phase + "_profile", steps=PROFILED_STEPS, nvidia_smi=smi,
         **breakdown)
    # checksums() wrapped the positions; the kernels are timed on the state
    # the next step would give them, with these inputs in moving-window mode
    sim.state = stepped
    f = stepper._f
    anchors = list(geom.prob_lo)
    anchors[1] = aux["tile_anchor"]
    zshift = int(np.round(f(f(aux["window_lo"] - aux["tile_anchor"])
                            / f(geom.dx[1]))))
    return launches, tuple(anchors), zshift, waits_by_step


def k2_window_at_main_shapes(sim, anchors, zshift, mxu="f32"):
    """K2 in moving-window mode on the state the run ended in, against its
    plain version and timed (``fused_at_main_shapes``)."""
    stepper = sim.stepper
    fields6 = stepper.to_kernel_frame(stepper._padded_eb(sim.state.fields))
    return fused_at_main_shapes(
        sim, 1, window=(fields6, stepper.params, anchors, zshift,
                        stepper.smax), mxu=mxu)


def add_launches(rows_by_name, launches, phase):
    for nm, row in rows_by_name.items():
        row["launches"] += launches[nm]
        row.setdefault("launches_by_path", {})[phase] = launches[nm]


def phase_main_lwfa(dev, smi, k2_row, k3_row, nx=2048, nz=8192):
    """lwfa2d-2048x8192 (the configuration built field for field) through K2
    in moving-window mode (K1c) at 'f32' and K3; returns K1c's kernels-line
    row and adds this path's launches to the rows of K2 and K3."""
    import warpx_tpu_torch
    from warpx_tpu_torch.ops import tiling

    cfg = main_lwfa_cfg(nx, nz, lwfa_steps(LWFA_PLAN))
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    launches, anchors, zshift, _ = run_lwfa_path(dev, smi, "main_lwfa",
                                                 sim, LWFA_PLAN)
    k1c = k2_window_at_main_shapes(sim, anchors, zshift)
    k3 = k3_at_main_shapes(sim, origin=anchors,
                           wrap_dims=sim.stepper.wrap_dims)
    emit("main_lwfa_layers", step=sim.state.step, zshift=zshift,
         ms=lwfa_layers(sim, anchors, zshift), fused_pic_2d=k1c["ms"],
         ragged_expand=k3["ms"], nvidia_smi=smi)
    add_launches({"fused_pic_2d": k2_row, "ragged_expand": k3_row}, launches,
                 "main_lwfa")
    k3_row["at_main_lwfa"] = k3
    return {"name": "fused_pic_moving_window", "route": "cuda",
            "source": "warpx_tpu_torch/csrc/fused_pic_2d.cu",
            "replaces": "warpx_tpu/ops/pallas_pic.py:197",
            "launches": launches["fused_pic_2d"], "zshift": zshift,
            "smax": sim.stepper.smax, **k1c}


def lwfa_deck_text(nx, nz, steps, mxu):
    """bench.py::run_lwfa's deck as bench.py formats it (2 x 2 particles
    per cell, sort interval 16), with max_step the steps the phase runs:
    the slot capacity of continuous injection grows with max_step."""
    return LWFA_2D_DECK.format(nx=nx, nz=nz, ppcx=2, ppcz=2, interval=16,
                               max_step=steps, mxu=mxu)


def phase_main_lwfa_deck(dev, smi, k3_row, nx=2048, nz=8192):
    """lwfa2d-2048x8192 from bench.py's deck text through
    Simulation.from_deck at tile_mxu = mixed (bench.py's default), driven
    as main_lwfa is; its configuration must equal main_lwfa's but for the
    mode.  Then K2 in moving-window mode at 'mixed' at its shapes against
    its plain version, timed beside K1c at 'f32' on the same state and
    beside its bound.  Returns the kernels-line row; adds this path's K3
    launches to ``k3_row``."""
    import warpx_tpu_torch
    from warpx_tpu_torch.utils.parser import Deck

    steps = lwfa_steps(LWFA_PLAN)
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(lwfa_deck_text(nx, nz, steps, "mixed")),
        dtype=torch.float32, device=dev)
    if sim.cfg != dataclasses.replace(main_lwfa_cfg(nx, nz, steps),
                                      tile_mxu="mixed"):
        raise AssertionError("the deck's configuration differs from "
                             "main_lwfa's")
    launches, anchors, zshift, waits = run_lwfa_path(
        dev, smi, "main_lwfa_deck", sim, LWFA_PLAN)
    row = k2_window_at_main_shapes(sim, anchors, zshift, mxu="mixed")
    add_launches({"ragged_expand": k3_row}, launches, "main_lwfa_deck")
    return {"name": "fused_pic_moving_window_mixed", "route": "cuda",
            "source": "warpx_tpu_torch/csrc/fused_pic_2d.cu",
            "replaces": "warpx_tpu/ops/pallas_pic.py:433", "mxu": "mixed",
            "launches": launches["fused_pic_2d"], "launches_by_path": {
                "main_lwfa_deck": launches["fused_pic_2d"]},
            "zshift": zshift, "smax": sim.stepper.smax, **row}, waits


# ---- the PSATD spectral solver ---------------------------------------------

C_LIGHT = 299792458.0
# seeded random fields for the solver pushes: E [V/m], B [T], J [A/m^2], F, G
PSATD_SCALE = {"E": 1e10, "B": 30.0, "j": 1e12, "F": 1e10, "G": 1e9}
# LWFA_PSATD_PLAN's 20 steps rebin at steps 0 and 16 (38 steps, warm 16
# and counted 8, until the script needed the time for later phases)
LWFA_PSATD_PLAN = dict(warm=4, timed=8, counted=2, interval=16)


def psatd_deck(text):
    """A laser-wakefield deck with the standard PSATD solver and Esirkepov
    deposition, which the tile-binned step takes (PSATD's default, direct
    deposition, runs per particle: psatd_variants_parity drives it), as
    psatd_parity and main_lwfa_psatd have run it since they were added."""
    return text.replace("algo.maxwell_solver = yee",
                        "algo.maxwell_solver = psatd\n"
                        "algo.current_deposition = esirkepov")


def psatd_slice_cfg(ndim):
    """tests/test_torch_psatd_slice.py's decks: small_cfg's plasma at 16^3,
    order 1, psatd_order 16 on the guard-padded boxes, or at 32^2, order 3,
    on one periodic box; 6 steps at dt = 0.999 dx / c."""
    cfg = small_cfg(ndim)
    return dataclasses.replace(
        cfg, em_solver="psatd", psatd_order=16, max_step=6,
        psatd_periodic_single_box=ndim == 2,
        particle_shape=1 if ndim == 3 else 3,
        dt=0.999 * min(cfg.geometry.dx) / C_LIGHT)


def psatd_solver_parity(dev):
    """PsatdSolver.push (3D, 2D) and PsatdPmlSolver.push (2D, F/G splits)
    on seeded random fields, float64, card (cuFFT) against CPU (pocketfft):
    the worst error over each output's largest value."""
    from warpx_tpu_torch.core.grid import Geometry, yee_staggering
    from warpx_tpu_torch.solvers.psatd import (PsatdPmlSolver, PsatdSolver,
                                               pml_split_dirs)

    worst = {}
    for ndim, n_cell in ((3, (16, 16, 32)), (2, (64, 128))):
        geom = Geometry(ndim=ndim, n_cell=n_cell, prob_lo=(-8e-6,) * ndim,
                        prob_hi=(8e-6,) * ndim, periodic=(True,) * ndim)
        stag = yee_staggering(ndim)
        dt = 0.5 * min(geom.dx) / C_LIGHT
        rng = np.random.default_rng(ndim)
        names = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")
        data = {nm: rng.normal(size=n_cell) * PSATD_SCALE[nm[0]]
                for nm in names}
        comps = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "F", "G")
        splits = {(nm, ax): rng.normal(size=n_cell) * PSATD_SCALE[nm[0]]
                  for nm in comps for ax in pml_split_dirs(nm, True)}
        outs = {}
        for device in (dev, "cpu"):
            kw = dict(dtype=torch.float64, device=device)
            sol = PsatdSolver(geom, stag, dt, **kw)
            got = sol.push({nm: torch.from_numpy(a).to(device)
                            for nm, a in data.items()})
            outs[str(device)] = {nm: got[nm].cpu() for nm in names[:6]}
            if ndim == 2:
                pml = PsatdPmlSolver(geom, stag, dt, dive_cleaning=True,
                                     divb_cleaning=True, **kw)
                got = pml.push({k: torch.from_numpy(a).to(device)
                                for k, a in splits.items()})
                outs[str(device)].update(
                    {f"pml:{k[0]}:{k[1]}": v.cpu() for k, v in got.items()})
        for nm, ref in outs["cpu"].items():
            err = rel_err(outs[str(dev)][nm], ref)[1]
            worst[f"{ndim}d:{nm}"] = err
            if err > 1e-12:
                raise AssertionError(f"PSATD push {ndim}D {nm}: card against "
                                     f"CPU {err}")
    return max(worst.values())


def div_agree(got, ref, tol, what):
    """divE and divB cell by cell: the worst difference over the largest
    |value|; raises above ``tol``."""
    out = {}
    for k in ("divE", "divB"):
        a, b = got[k].double().cpu(), ref[k].double().cpu()
        out[k] = rel_err(a, b)[1]
        if out[k] > tol:
            raise AssertionError(f"{what} {k}: {out[k]} of its largest value")
    return out


def phase_psatd_parity(dev):
    """The standard PSATD solver in float64, card against CPU: the solver
    pushes at 1e-12; then the 16^3 (K1) and 32^2 (K2) periodic decks and
    the 32 x 64 laser-wakefield deck (K1c: PML with F/G splits, moving
    window, 8 steps, a rebin at 4) through the tile-binned step, every
    checksum within 1e-9 and divE/divB within 1e-9 of their largest value
    cell by cell, the fused kernel launched once per step; and each deck's
    float32 run on the card against its float64 run (``float32_spread``),
    the 32 x 64 deck's under Yee beside it."""
    import warpx_tpu_torch
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.utils.parser import Deck

    solver_err = psatd_solver_parity(dev)
    lwfa = psatd_deck(LWFA_32X64_DECK).replace("max_step = 12",
                                               "max_step = 8")

    def periodic(ndim):
        return lambda device, dtype=torch.float64: warpx_tpu_torch.Simulation(
            psatd_slice_cfg(ndim), dtype=dtype, device=device)

    def bounded(device, dtype=torch.float64):
        return warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(lwfa), dtype=dtype, device=device)

    cases = []
    for name, make, counter in (("periodic_16^3", periodic(3), "launches"),
                                ("periodic_32^2", periodic(2), "launches_2d"),
                                ("lwfa_32x64", bounded, "launches_2d")):
        sums, divs = {}, {}
        before = getattr(fp.binned_push_deposit, counter)
        for device in (dev, "cpu"):
            sim = make(device)
            if not sim.binned or sim.cfg.em_solver != "psatd":
                raise AssertionError(f"{name} did not take the tile-binned "
                                     "PSATD step")
            sim.init()
            sim.evolve()
            divs[str(device)] = sim.field_diagnostics()
            sums[str(device)] = sim.checksums()  # raises on overflow etc.
            if device is dev:
                aux = sim.state.aux
                steps = sim.cfg.max_step
        grew = getattr(fp.binned_push_deposit, counter) - before
        if grew != steps:
            raise AssertionError(f"{name}: {grew} fused launches in {steps} "
                                 "steps")
        if sim.is_bounded and not aux["window_offset"] > 0:
            raise AssertionError(f"{name}: the window did not move")
        worst = checksums_agree(sums[str(dev)], sums["cpu"], 1e-9,
                                f"{name} card vs CPU")
        cases.append({"case": name, "steps": steps, "fused_launches": grew,
                      "max_rel_err": worst,
                      "div_rel_err": div_agree(divs[str(dev)], divs["cpu"],
                                               1e-9, name),
                      "window_offset": int(aux.get("window_offset", 0)),
                      "float32_spread": float32_spread(make, dev,
                                                       sums[str(dev)])})
    # the same spread under Yee, for scale
    def yee(device, dtype=torch.float64):
        return warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(LWFA_32X64_DECK.replace("max_step = 12",
                                                     "max_step = 8")),
            dtype=dtype, device=device)

    ref = yee(dev)
    ref.init()
    ref.evolve()
    emit("psatd_parity", ok=True, tol=1e-9, solver_push_max_rel_err=solver_err,
         solver_tol=1e-12, cases=cases,
         lwfa_32x64_yee_float32_spread=float32_spread(yee, dev,
                                                      ref.checksums()))


def float32_spread(make, dev, sums64):
    """The run of ``make`` in float32 on the card against its float64 run's
    checksums ``sums64``: the largest relative difference of each field's
    and each species' checksums (divE/divB left out), reported, not held
    to a bound."""
    sim = make(dev, torch.float32)
    sim.init()
    sim.evolve()
    sums = sim.checksums()
    out = {}
    for group, ref in sums64.items():
        out[group] = max(
            (abs(sums[group][q] - a) / abs(a) for q, a in ref.items()
             if a and q not in ("divE", "divB")), default=0.0)
    return out


def psatd_push_cost(push):
    """One spectral push (``push()``): its FFT calls (counted on
    torch.fft), its device kernels and their device time (torch.profiler),
    and its time from CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    calls = {"fftn": 0, "ifftn": 0}
    orig = {nm: getattr(torch.fft, nm) for nm in calls}

    def counted(nm):
        def fn(*a, **kw):
            calls[nm] += 1
            return orig[nm](*a, **kw)
        return fn

    for nm in calls:
        setattr(torch.fft, nm, counted(nm))
    try:
        push()
    finally:
        for nm, fn in orig.items():
            setattr(torch.fft, nm, fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        push()
        torch.cuda.synchronize()
    launches = fft_launches = 0
    device_ms = fft_ms = 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        launches += evt.count
        device_ms += us / 1e3
        if "fft" in evt.key.lower():
            fft_launches += evt.count
            fft_ms += us / 1e3
    return {"fft_calls": calls, "kernel_launches": launches,
            "fft_kernel_launches": fft_launches, "device_ms": device_ms,
            "fft_device_ms": fft_ms, "ms": cuda_ms(push, 3)}


def phase_main_psatd(dev, smi, k1_row, k3_row, n=128):
    """uniform-128-psatd: main's plasma and dt with the standard PSATD
    solver (psatd_order 16, guard-padded boxes of (n + 16)^3), 25 steps
    through K1 and K3 as main drives them; then one spectral push timed
    alone on the final state.  Adds this path's launches to the rows of K1
    and K3."""
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling

    cfg = dataclasses.replace(main_cfg(n), em_solver="psatd", psatd_order=16)
    sim, launches = run_main_path(
        dev, smi, "main_psatd", cfg, 2 * 2 * n ** 3, 20,
        {"fused_pic": (fp.binned_push_deposit, "launches"),
         "ragged_expand": (tiling.ragged_expand, "launches")})
    if sim.psatd is None or sim.psatd.n_fft != (n + 16,) * 3:
        raise AssertionError(f"main_psatd's solver: {sim.psatd}")
    f = sim.state.fields
    names = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")
    cost = psatd_push_cost(
        lambda: sim.psatd.push({nm: getattr(f, nm) for nm in names}))
    emit("main_psatd_push", n_fft=sim.psatd.n_fft, **cost, nvidia_smi=smi)
    add_launches({"fused_pic": k1_row, "ragged_expand": k3_row}, launches,
                 "main_psatd")


def phase_main_lwfa_psatd(dev, smi, k1c_row, k3_row, nx=2048, nz=8192):
    """lwfa2d-2048x8192-psatd: bench.py's deck text with the standard PSATD
    solver and Esirkepov deposition (named in the deck, so that the run
    takes the tile-binned step and its numbers stay comparable with the
    earlier runs of this phase) through Simulation.from_deck at 'mixed'
    (PML on four faces with their F/G splits, the extended box of
    (nx + 20) x (nz + 20) transformed whole), 20 steps with rebins at 0
    and 16, driven as main_lwfa is; then the spectral push (with the PML
    splits) timed alone on the final state, and K2 in moving-window mode at
    'mixed' at its shapes against its plain version, with the tiles that
    took its checked path (``k1c_wide_tiles.py`` counts them at this step
    under Yee too).  Adds this path's launches to the rows of K1c at
    'mixed' and K3."""
    import warpx_tpu_torch
    from warpx_tpu_torch.utils.parser import Deck

    steps = lwfa_steps(LWFA_PSATD_PLAN)
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(psatd_deck(lwfa_deck_text(nx, nz, steps, "mixed"))),
        dtype=torch.float32, device=dev)
    launches, anchors, zshift, waits = run_lwfa_path(
        dev, smi, "main_lwfa_psatd", sim, LWFA_PSATD_PLAN)
    st = sim.stepper
    if st.psatd is None or st.psatd_pml is None or not st.psatd_pml.cleaning:
        raise AssertionError("main_lwfa_psatd did not run the spectral PML")
    state = sim.state
    cost = psatd_push_cost(lambda: st.psatd_push(state.fields,
                                                 dict(state.aux)))
    n_splits = sum(k.startswith("pml:") for k in state.aux)
    row = k2_window_at_main_shapes(sim, anchors, zshift, mxu="mixed")
    emit("main_lwfa_psatd_push", n_fft=st.psatd.n_fft, pml_splits=n_splits,
         **cost, fused_pic_moving_window_mixed={
             k: row[k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err",
                                 "wide_tiles", "occupied_tiles")},
         idle_waits=waits["idle"], nvidia_smi=smi)
    add_launches({"fused_pic_moving_window_mixed": k1c_row,
                  "ragged_expand": k3_row},
                 {"fused_pic_moving_window_mixed": launches["fused_pic_2d"],
                  "ragged_expand": launches["ragged_expand"]},
                 "main_lwfa_psatd")


# ---- the rest of PSATD (Galilean, multi-J, rho, averaging, Vay, direct) ----

# family -> the SimConfig fields that select it (as in
# tests/test_torch_psatd_variants.py)
PSATD_FAMILIES = {
    "galilean": dict(psatd_v_galilean=(0.0, 0.0, 0.5 * C_LIGHT),
                     psatd_update_with_rho=True),
    "averaged": dict(psatd_v_galilean=(0.0, 0.0, 0.3 * C_LIGHT),
                     psatd_update_with_rho=True, psatd_time_averaging=True),
    "current_correction": dict(current_deposition="direct",
                               psatd_current_correction=True),
    "multi_j": dict(current_deposition="direct", psatd_j_in_time="linear",
                    psatd_current_correction=True),
    "first_order": dict(current_deposition="direct",
                        psatd_solution_type="first-order",
                        psatd_j_in_time="linear", multi_j_n_depositions=2,
                        do_dive_cleaning=True, do_divb_cleaning=True,
                        psatd_update_with_rho=True),
    "vay": dict(current_deposition="vay"),
    "direct": dict(current_deposition="direct"),
    "cleaning": dict(do_dive_cleaning=True, do_divb_cleaning=True,
                     psatd_update_with_rho=True),
    "comoving": dict(current_deposition="direct",
                     psatd_v_comoving=(0.0, 0.0, 0.4 * C_LIGHT),
                     psatd_update_with_rho=True),
}
# the one family the tile-binned gate admits beyond the standard solver:
# first-order PSATD with J constant in time (the binned step then runs the
# solver's second-order push, as the JAX package's does)
PSATD_BINNED_FAMILY = dict(psatd_solution_type="first-order")


def psatd_family_cfg(ndim, family, tiled="off", steps=2):
    """small_cfg's plasma drifting along z at 0.3 c with ``family``'s PSATD
    (psatd_order 16 on guard-padded boxes, bilinear filter), 2 steps, per
    particle unless ``tiled``."""
    cfg = small_cfg(ndim)
    species = tuple(dataclasses.replace(sp, uz=0.3) for sp in cfg.species)
    kw = (PSATD_BINNED_FAMILY if family == "binned"
          else PSATD_FAMILIES[family])
    return dataclasses.replace(
        cfg, species=species, em_solver="psatd", psatd_order=16,
        max_step=steps, use_filter=True, tiled_particles=tiled,
        dt=0.999 * min(cfg.geometry.dx) / C_LIGHT, **kw)


def family_sums_agree(got, ref, tol, what):
    """checksums_agree, with G (the div B cleaning scalar, roundoff that
    two FFT libraries sum in different orders) held at ``tol`` of c times
    the B checksums, the scale its update i c S/|k| k.B gives it."""
    g = {grp: v.pop("G") for grp, v in ref.items() if "G" in v}
    worst = checksums_agree(got, ref, tol, what)
    for grp, a in g.items():
        ref[grp]["G"] = a
        scale = C_LIGHT * sum(ref[grp][k] for k in ("Bx", "By", "Bz"))
        r = abs(got[grp]["G"] - a) / scale
        worst = max(worst, r)
        if r > tol:
            raise AssertionError(f"{what} checksum {grp}/G: "
                                 f"{got[grp]['G']!r} vs {a!r}")
    return worst


def psatd_variant_pushes(dev):
    """Each solver push this slice adds, alone, float64, card (cuFFT)
    against CPU on seeded fields: the J-linear push (``j_old``, with
    current correction), PsatdFirstOrder.push_first_order (J and rho
    linear with F/G cleaning, and J linear without), the time-averaged
    Galilean push with its rho pair, comoving and Vay; worst error over
    each output's largest value, held to 1e-12."""
    from warpx_tpu_torch.core.grid import Geometry, yee_staggering
    from warpx_tpu_torch.solvers.psatd import PsatdFirstOrder, PsatdSolver

    names = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")
    worst = {}
    for ndim, n_cell in ((3, (16, 16, 32)), (2, (64, 128))):
        geom = Geometry(ndim=ndim, n_cell=n_cell, prob_lo=(-8e-6,) * ndim,
                        prob_hi=(8e-6,) * ndim, periodic=(True,) * ndim)
        stag = yee_staggering(ndim)
        dt = 0.5 * min(geom.dx) / C_LIGHT
        rng = np.random.default_rng(10 + ndim)
        data = {nm: rng.normal(size=n_cell) * PSATD_SCALE[nm[0]]
                for nm in names + ("F", "G")}
        src = {k: rng.normal(size=n_cell) * (1e12 if k[0] == "j" else 1e3)
               for k in ("j0x", "j0y", "j0z", "j1x", "j1y", "j1z", "r0",
                         "r1")}
        eb = names[:6]
        avg = tuple(nm + "_avg" for nm in eb)
        # case -> (solver, its keywords, the call, the outputs held)
        cases = {
            "j_linear": (PsatdSolver, dict(current_correction=True),
                         "push_j_old", eb + names[6:]),
            "first_order_clean": (PsatdFirstOrder, dict(
                div_cleaning=True, update_with_rho=True), "first_clean",
                eb + ("F", "G")),
            "first_order": (PsatdFirstOrder, dict(), "first", eb),
            "averaged_galilean": (PsatdSolver, dict(
                v_galilean=(0.0, 0.0, 0.6 * C_LIGHT), update_with_rho=True,
                time_averaging=True), "push_rho", eb + avg),
            "comoving": (PsatdSolver, dict(
                v_comoving=(0.0, 0.0, -0.7 * C_LIGHT), update_with_rho=True,
                current_correction=True), "push_rho", eb + names[6:]),
            "vay": (PsatdSolver, dict(vay_deposition=True), "push",
                    eb + names[6:]),
        }
        for case, (cls, kw, how, held) in cases.items():
            outs = {}
            for device in (dev, "cpu"):
                def t(a):
                    return torch.from_numpy(a).to(device)

                sol = cls(geom, stag, dt * (0.5 if cls is PsatdFirstOrder
                                            else 1.0),
                          dtype=torch.float64, device=device, **kw)
                fields = {nm: t(a) for nm, a in data.items()}
                j0 = tuple(t(src[k]) for k in ("j0x", "j0y", "j0z"))
                j1 = tuple(t(src[k]) for k in ("j1x", "j1y", "j1z"))
                rho = (t(src["r0"]), t(src["r1"]))
                if how == "push_j_old":
                    out = sol.push(fields, rho, j_old=j0)
                elif how == "first_clean":
                    out = sol.push_first_order(fields, j0, j1, *rho)
                elif how == "first":
                    out = sol.push_first_order(fields, j0, j1)
                elif how == "push_rho":
                    out = sol.push(fields, rho)
                else:
                    out = sol.push(fields)
                outs[str(device)] = {nm: out[nm].cpu() for nm in held}
            for nm, ref in outs["cpu"].items():
                err = rel_err(outs[str(dev)][nm], ref)[1]
                worst[f"{ndim}d:{case}:{nm}"] = err
                if err > 1e-12:
                    raise AssertionError(f"{case} push {ndim}D {nm}: card "
                                         f"against CPU {err}")
    return max(worst.values()), len(worst)


def run_both(make, dev):
    """``make(device)``'s run on the card and on the CPU, float64: their
    checksums, divE/divB and the card's simulation."""
    sums, divs = {}, {}
    for device in (dev, "cpu"):
        sim = make(device)
        sim.init()
        sim.evolve()
        divs[str(device)] = sim.field_diagnostics()
        sums[str(device)] = sim.checksums()
        if device is dev:
            card = sim
    return sums, divs, card


def phase_psatd_variants_parity(dev):
    """The PSATD families of this slice in float64, card against CPU: each
    new solver push alone at 1e-12 (``psatd_variant_pushes``); every
    family of PSATD_FAMILIES on the 16^3 and 32^2 periodic decks, per
    particle, 3 steps; the first-order J-constant decks through the
    tile-binned step (K1, K2 and K3 launch; their launches are returned by
    path for the kernels line); the rho-free time-averaged and comoving
    decks, which both packages refuse to build; the 32 x 64
    laser-wakefield deck with psatd.v_galilean = 0 0 0.5 and the moving
    window (and with time averaging), per particle, 8 steps; the same deck
    as PSATD with no deposition key (direct deposition, current
    correction), per particle.  Every checksum within 1e-9 (G as in
    ``family_sums_agree``) and divE/divB within 1e-9 of their largest
    value cell by cell; the float32 spread of the 32 x 64 decks
    reported, not bounded."""
    import warpx_tpu_torch
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling
    from warpx_tpu_torch.utils.parser import Deck

    push_err, n_outputs = psatd_variant_pushes(dev)

    def sim_of(cfg):
        return lambda device, dtype=torch.float64: warpx_tpu_torch.Simulation(
            cfg, dtype=dtype, device=device)

    cases = []
    for ndim in (3, 2):
        for family in PSATD_FAMILIES:
            sums, divs, sim = run_both(sim_of(psatd_family_cfg(ndim, family)),
                                       dev)
            if sim.binned:
                raise AssertionError(f"{family} {ndim}D ran binned")
            cases.append({
                "case": f"{family}_{ndim}d", "max_rel_err": family_sums_agree(
                    sums[str(dev)], sums["cpu"], 1e-9, f"{family} {ndim}D"),
                "div_rel_err": div_agree(divs[str(dev)], divs["cpu"], 1e-9,
                                         f"{family} {ndim}D")})

    binned_launches = {"fused_pic": 0, "fused_pic_2d": 0,
                       "ragged_expand": 0}
    for ndim, counter in ((3, "launches"), (2, "launches_2d")):
        cfg = psatd_family_cfg(ndim, "binned", tiled="on")
        k_before = getattr(fp.binned_push_deposit, counter)
        r_before = tiling.ragged_expand.launches
        sums, divs, sim = run_both(sim_of(cfg), dev)
        grew = getattr(fp.binned_push_deposit, counter) - k_before
        rebins = tiling.ragged_expand.launches - r_before
        if not sim.binned or grew != cfg.max_step or not rebins:
            raise AssertionError(f"first-order binned {ndim}D: binned "
                                 f"{sim.binned}, {grew} fused launches, "
                                 f"{rebins} rebin launches")
        binned_launches["fused_pic" if ndim == 3 else "fused_pic_2d"] += grew
        binned_launches["ragged_expand"] += rebins
        cases.append({
            "case": f"first_order_j_constant_binned_{ndim}d",
            "fused_launches": grew, "rebin_launches": rebins,
            "max_rel_err": checksums_agree(sums[str(dev)], sums["cpu"], 1e-9,
                                           f"binned {ndim}D"),
            "div_rel_err": div_agree(divs[str(dev)], divs["cpu"], 1e-9,
                                     f"binned {ndim}D")})
    refused = {}
    for family, kw in (("averaged", dict(psatd_time_averaging=True)),
                       ("comoving", dict(
                           psatd_v_comoving=(0.0, 0.0, 0.4 * C_LIGHT)))):
        cfg = dataclasses.replace(psatd_family_cfg(2, "binned", tiled="on"),
                                  psatd_solution_type="second-order", **kw)
        try:
            warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device=dev)
        except NotImplementedError as e:
            refused[family] = str(e)
        else:
            raise AssertionError(f"rho-free {family} PSATD was built")

    base = LWFA_32X64_DECK.replace("max_step = 12", "max_step = 8").replace(
        "algo.maxwell_solver = yee", "algo.maxwell_solver = psatd")
    galilean = base + ("algo.current_deposition = esirkepov\n"
                       "psatd.v_galilean = 0. 0. 0.5\n")
    decks = {"lwfa_32x64_galilean": galilean,
             "lwfa_32x64_galilean_averaged":
                 galilean + "psatd.do_time_averaging = 1\n",
             "lwfa_32x64_direct": base}
    for name, text in decks.items():
        def make(device, dtype=torch.float64, text=text):
            return warpx_tpu_torch.Simulation.from_deck(
                Deck.from_string(text), dtype=dtype, device=device)

        sums, divs, sim = run_both(make, dev)
        if sim.binned or not sim.is_bounded:
            raise AssertionError(f"{name} did not take the bounded "
                                 "per-particle step")
        if name == "lwfa_32x64_direct" and (
                sim.cfg.current_deposition != "direct"
                or not sim.cfg.psatd_current_correction):
            raise AssertionError(f"{name}: {sim.cfg.current_deposition}")
        if not sim.state.aux["window_offset"] > 0:
            raise AssertionError(f"{name}: the window did not move")
        cases.append({
            "case": name, "steps": sim.cfg.max_step,
            "window_offset": int(sim.state.aux["window_offset"]),
            "max_rel_err": checksums_agree(sums[str(dev)], sums["cpu"], 1e-9,
                                           name),
            "div_rel_err": div_agree(divs[str(dev)], divs["cpu"], 1e-9, name),
            "float32_spread": float32_spread(make, dev, sums[str(dev)])})
    emit("psatd_variants_parity", ok=True, tol=1e-9,
         solver_push_max_rel_err=push_err, solver_push_outputs=n_outputs,
         solver_tol=1e-12, cases=cases, binned_launches=binned_launches,
         refused_binned=refused)
    return binned_launches


class timed_deposits:
    """Within the block, every deposit ``core.step`` makes (rho, Esirkepov,
    direct) records its device time with CUDA events, in call order."""

    NAMES = ("deposit_rho", "deposit_current_esirkepov",
             "deposit_current_direct")

    def __enter__(self):
        from warpx_tpu_torch.core import step as step_mod

        self.mod, self.calls, self.orig = step_mod, [], {}
        for nm in self.NAMES:
            fn = self.orig[nm] = getattr(step_mod, nm)
            setattr(step_mod, nm, self._timed(nm, fn))
        return self

    def _timed(self, nm, fn):
        def run(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            self.calls.append((nm, ev))
            return out
        return run

    def __exit__(self, *exc):
        for nm, fn in self.orig.items():
            setattr(self.mod, nm, fn)

    def report(self, steps):
        torch.cuda.synchronize()
        seq = [(nm, a.elapsed_time(b)) for nm, (a, b) in self.calls]
        per_fn = {}
        for nm, ms in seq:
            per_fn[nm] = per_fn.get(nm, 0.0) + ms / steps
        return {"ms_per_step": per_fn, "calls_per_step": len(seq) // steps,
                "ms_each_call_last_step": [
                    {"fn": nm, "ms": ms} for nm, ms in
                    seq[len(seq) - len(seq) // steps:]]}


def field_energy(fields, geom):
    """Electromagnetic energy in the box [J]: eps0/2 E^2 + B^2/(2 mu0)."""
    ep0 = 8.8541878128e-12
    mu0 = 1.25663706212e-06
    e2 = sum((getattr(fields, nm).double() ** 2).sum()
             for nm in ("Ex", "Ey", "Ez"))
    b2 = sum((getattr(fields, nm).double() ** 2).sum()
             for nm in ("Bx", "By", "Bz"))
    return float((0.5 * ep0 * e2 + 0.5 * b2 / mu0) * geom.cell_volume)


# the drifting plasma's steps (25 until the script needed the time for
# later phases)
DRIFT_STEPS = 13


def drifting_cfg(n=128, steps=DRIFT_STEPS, **psatd):
    """uniform-128's plasma (main_cfg: n^3 cells, 2 x 2 n^3 particles,
    order 1, its dt) with both species drifting along z at gamma = 10
    (u_z = 9.95 c, thermal spread 0.01 c) under PSATD (psatd_order 16),
    per particle: the drifting-plasma family of WarpX's
    Examples/Tests/nci_psatd_stability decks on this repo's main box."""
    cfg = main_cfg(n, steps)
    species = tuple(dataclasses.replace(sp, uz=9.95) for sp in cfg.species)
    return dataclasses.replace(cfg, species=species, em_solver="psatd",
                               psatd_order=16, tiled_particles="auto",
                               **psatd)


def run_per_particle_path(dev, smi, phase, cfg, n_particles, steps):
    """Drive a per-particle main path through Simulation as run_main_path
    drives a binned one: init, a warm step, ``steps`` timed steps (CUDA
    events), PROFILED_STEPS_PER_PARTICLE profiled steps (device busy
    share), one step
    with its deposits timed one by one, the closing step.  Checks every
    particle alive, weight conserved and finite fields of the grid's
    shape; emits the phase's line and its profile.  Returns the
    simulation."""
    import warpx_tpu_torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    if sim.binned:
        raise AssertionError(f"{phase} took the tile-binned step")
    sim.init()
    sim.evolve(1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    geom = cfg.geometry
    energy = [(sim.state.step, field_energy(sim.state.fields, geom))]
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    marks[0].record()
    for mark in marks[1:]:
        sim.evolve(1)
        mark.record()
    marks[-1].synchronize()
    ms_total = marks[0].elapsed_time(marks[-1])
    series = [round(a.elapsed_time(b), 3) for a, b in zip(marks, marks[1:])]
    energy.append((sim.state.step, field_energy(sim.state.fields, geom)))
    breakdown = profile_steps(sim, PROFILED_STEPS_PER_PARTICLE)
    with timed_deposits() as dep:
        sim.evolve(1)
    deposits = dep.report(1)
    sim.evolve()  # the closing step, with the +dt/2 synchronization
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    energy.append((sim.state.step, field_energy(sim.state.fields, geom)))
    sums = sim.checksums()
    for group in sums.values():
        for q, v in group.items():
            if not np.isfinite(v):
                raise AssertionError(f"{phase}: non-finite checksum {q}")
    alive = sum(int(sp.alive.sum()) for sp in sim.state.species.values())
    if alive != n_particles:
        raise AssertionError(f"{phase}: {alive} alive of {n_particles}")
    for sp_cfg in cfg.species:
        total_w = sp_cfg.density * geom.cell_volume * np.prod(geom.n_cell)
        w_rel = abs(sums[sp_cfg.name]["particle_weight"] / total_w - 1)
        if w_rel > 1e-5:
            raise AssertionError(f"{sp_cfg.name} weight drifted by {w_rel}")
    f = sim.state.fields
    for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz", "F",
               "G"):
        a = getattr(f, nm)
        if a is None:
            continue
        if (tuple(a.shape) != tuple(geom.n_cell)
                or not bool(torch.isfinite(a).all())):
            raise AssertionError(f"{phase}: field {nm} is not finite at "
                                 f"{geom.n_cell}")
    ms_step = ms_total / steps
    emit(phase, ok=True, n_cell=geom.n_cell, n_particles=n_particles,
         order=cfg.particle_shape, steps_timed=steps, ms_per_step=ms_step,
         pushes_per_s=n_particles / (ms_step * 1e-3), init_s=init_s,
         ms_each_step=series, device_busy_share=breakdown[
             "device_busy_share"], peak_memory_bytes=peak,
         deposits=deposits,
         field_energy_J=[{"step": s, "energy": e} for s, e in energy],
         checksum_Ex=sums["lev=0"]["Ex"], checksum_jz=sums["lev=0"]["jz"],
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    emit(phase + "_profile", steps=PROFILED_STEPS_PER_PARTICLE,
         **breakdown)
    return sim


def phase_main_psatd_galilean(dev, smi, n=128):
    """uniform-128-galilean: the drifting plasma (``drifting_cfg``) with
    Galilean PSATD at v_galilean = beta c e_z (beta = sqrt(1 - 1/gamma^2)),
    update-with-rho on (rho at t^n and t^{n+1} beside J at t^{n+1/2}, each
    at its own origin), Esirkepov deposition, per particle (the
    tile-binned gate refuses rho deposits), DRIFT_STEPS steps with the
    last DRIFT_STEPS - 5 timed; then the spectral push with its rho pair
    timed alone."""
    gamma = 10.0
    beta = (1.0 - 1.0 / gamma ** 2) ** 0.5
    cfg = drifting_cfg(n, steps=DRIFT_STEPS,
                       psatd_v_galilean=(0.0, 0.0, beta * C_LIGHT),
                       psatd_update_with_rho=True)
    sim = run_per_particle_path(dev, smi, "main_psatd_galilean", cfg,
                                2 * 2 * n ** 3, DRIFT_STEPS - 5)
    f = sim.state.fields
    names = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")
    rho = (torch.zeros_like(f.Ex), torch.zeros_like(f.Ex))
    cost = psatd_push_cost(lambda: sim.psatd.push(
        {nm: getattr(f, nm) for nm in names}, rho))
    emit("main_psatd_galilean_push", n_fft=sim.psatd.n_fft, **cost,
         nvidia_smi=smi)


def phase_main_psatd_multij(dev, smi, n=128):
    """uniform-128-multij: the drifting plasma with first-order PSATD,
    two depositions a step, J and rho constant in time, F/G cleaning,
    direct deposition (the family of WarpX's
    inputs_test_3d_uniform_plasma_multiJ), per particle, DRIFT_STEPS steps
    with the last DRIFT_STEPS - 5 timed; then one first-order sub-step push
    timed alone."""
    cfg = drifting_cfg(n, current_deposition="direct",
                       psatd_solution_type="first-order",
                       multi_j_n_depositions=2, psatd_j_in_time="constant",
                       psatd_rho_in_time="constant", do_dive_cleaning=True,
                       do_divb_cleaning=True, psatd_update_with_rho=True)
    sim = run_per_particle_path(dev, smi, "main_psatd_multij", cfg,
                                2 * 2 * n ** 3, DRIFT_STEPS - 5)
    f = sim.state.fields
    names = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz", "F", "G")
    fmap = {nm: getattr(f, nm) for nm in names}
    cost = psatd_push_cost(lambda: sim.psatd.push_first_order(
        fmap, (f.jx, f.jy, f.jz), None, torch.zeros_like(f.Ex), None))
    emit("main_psatd_multij_push", n_fft=sim.psatd.n_fft,
         sub_steps=cfg.multi_j_n_depositions, **cost, nvidia_smi=smi)


# ---- the boosted frame, back-transformed diagnostics, divergence cleaning --

GAMMA_BOOST = 10.0
BOOST_KEYS = ("warpx.gamma_boost = 10.\nwarpx.boost_direction = z\n")
CLEAN_KEYS = "warpx.do_dive_cleaning = 1\nwarpx.do_divb_cleaning = 1\n"
# tests/test_torch_btd.py's deck: the 32 x 64 deck's lab window moved to
# z in [-10, 24] um, four snapshots 2 ps apart (the JAX package's lab
# snapshot domain starts at prob_lo_boost / gamma: on the deck's own window
# positive lab times fill no row for hundreds of steps)
BTD_32X64 = ("diagnostics.diags_names = btd1\n"
             "btd1.diag_type = BackTransformed\n"
             "btd1.num_snapshots_lab = 4\n"
             "btd1.dt_snapshots_lab = 2.e-12\n")


def btd_32x64_deck():
    return (LWFA_32X64_DECK.replace("max_step = 12", "max_step = 8")
            .replace("geometry.prob_lo = -15.e-6 -28.e-6",
                     "geometry.prob_lo = -15.e-6 -10.e-6")
            .replace("geometry.prob_hi =  15.e-6   6.e-6",
                     "geometry.prob_hi =  15.e-6  24.e-6")
            .replace("laser1.position = 0. 0. -10.e-6",
                     "laser1.position = 0. 0. 20.e-6")
            + BOOST_KEYS + BTD_32X64)


def seed_divergent(sim):
    """B0 sin(2 pi x / Lx) in Bx at its nodes along x and E0 sin(2 pi x /
    Lx) in Ex at its cell centers (tests/test_torch_divclean.py's seed):
    both divergent, so that F and G grow."""
    geom = sim.cfg.geometry
    lx = geom.prob_hi[0] - geom.prob_lo[0]
    f = sim.state.fields
    upd = {}
    for nm, amp, off in (("Bx", 1e-1, 0.0), ("Ex", 1e9, 0.5)):
        x = (np.arange(geom.n_cell[0]) + off) * geom.dx[0]
        a = torch.as_tensor(amp * np.sin(2 * np.pi * x / lx),
                            dtype=f.Ex.dtype, device=f.Ex.device)
        shape = [1] * geom.ndim
        shape[0] = geom.n_cell[0]
        upd[nm] = a.reshape(shape).expand(getattr(f, nm).shape).contiguous()
    sim.state = sim.state.replace(fields=f.replace(**upd))


def fg_sums(sim):
    """The cleaning scalars' checksums: sum |F| and sum |G|."""
    f = sim.state.fields
    return {nm: float(getattr(f, nm).double().abs().sum())
            for nm in ("F", "G") if getattr(f, nm) is not None}


def phase_boosted_parity(dev):
    """The boosted frame, back-transformed diagnostics and divergence
    cleaning in float64, card against CPU at 1e-9: the 32 x 64
    laser-wakefield deck at gamma_boost = 10, tile-binned (K1c, launched
    once a step) and per particle, 8 steps; that deck with a
    BackTransformed diagnostic (``btd_32x64_deck``): the snapshot rows and
    ``filled`` masks; the 16^3 periodic plasma under Yee with both
    cleanings from divergent fields, per particle; the 32 x 64 deck with
    both cleanings under Yee with PML faces and under PSATD with PML faces,
    per particle: every checksum and sum |F|, sum |G|.  Each case's float32
    run on the card against its float64 run is reported
    (``float32_spread``)."""
    import warpx_tpu_torch
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.utils.parser import Deck

    lwfa8 = LWFA_32X64_DECK.replace("max_step = 12", "max_step = 8")
    out_dir = tempfile.mkdtemp(prefix="boosted_parity_")

    def deck(text):
        def make(device, dtype=torch.float64):
            return warpx_tpu_torch.Simulation.from_deck(
                Deck.from_string(text), dtype=dtype, device=device,
                output_dir=out_dir)
        return make

    def run(make, device, dtype, seed):
        sim = make(device, dtype)
        sim.init()
        if seed:
            seed_divergent(sim)
        sim.evolve()
        sums = sim.checksums()
        sums["lev=0"].update(fg_sums(sim))
        return sim, sums

    def periodic_clean(device, dtype=torch.float64):
        cfg = dataclasses.replace(small_cfg(3), tiled_particles="off",
                                  do_dive_cleaning=True,
                                  do_divb_cleaning=True, max_step=6)
        return warpx_tpu_torch.Simulation(cfg, dtype=dtype, device=device)

    cases = [
        ("boosted_binned", deck(lwfa8 + BOOST_KEYS), True),
        ("boosted_per_particle",
         deck(lwfa8 + BOOST_KEYS + "tpu.tiled_particles = off\n"), False),
        ("boosted_btd", deck(btd_32x64_deck()
                             + "tpu.tiled_particles = off\n"), False),
        ("periodic_16^3_yee_clean", periodic_clean, False),
        ("lwfa_32x64_yee_pml_clean", deck(lwfa8 + CLEAN_KEYS), False),
        ("lwfa_32x64_psatd_pml_clean",
         deck(psatd_deck(lwfa8) + CLEAN_KEYS), False),
    ]
    out = []
    for name, make, binned in cases:
        sums, btds = {}, {}
        before = fp.binned_push_deposit.launches_2d
        seed = "periodic" in name
        for device in (dev, "cpu"):
            sim, sums[str(device)] = run(make, device, torch.float64, seed)
            if sim.binned != binned:
                raise AssertionError(f"{name}: binned {sim.binned}")
            btds[str(device)] = sim.btd
            steps = sim.cfg.max_step
        grew = fp.binned_push_deposit.launches_2d - before
        if grew != (steps if binned else 0):
            raise AssertionError(f"{name}: {grew} K2 launches in {steps} "
                                 "steps")
        case = {"case": name, "steps": steps, "fused_launches": grew,
                "max_rel_err": checksums_agree(sums[str(dev)], sums["cpu"],
                                               1e-9, name)}
        if btds["cpu"]:
            (got,), (ref,) = btds[str(dev)], btds["cpu"]
            worst = 0.0
            for i in range(ref.num):
                if not np.array_equal(got.filled[i], ref.filled[i]):
                    raise AssertionError(f"{name}: snapshot {i}'s rows")
                a, b = got.data(i), ref.data(i)
                err = float(np.abs(a - b).max() / max(np.abs(b).max(),
                                                      1e-300))
                worst = max(worst, err)
                if err > 1e-9:
                    raise AssertionError(f"{name}: snapshot {i} {err}")
            case.update(btd_rows=[int(f.sum()) for f in ref.filled],
                        btd_max_rel_err=worst)
            if not sum(case["btd_rows"]):
                raise AssertionError(f"{name}: no row filled")
        if "clean" in name and not sums["cpu"]["lev=0"].get("G"):
            raise AssertionError(f"{name}: G stayed zero")
        # the float32 run on the card against the float64 one (reported)
        _, s32 = run(make, dev, torch.float32, seed)
        case["float32_spread"] = {
            group: max((abs(s32[group][q] - a) / abs(a)
                        for q, a in ref.items()
                        if a and q not in ("divE", "divB")), default=0.0)
            for group, ref in sums[str(dev)].items()}
        out.append(case)
    shutil.rmtree(out_dir, ignore_errors=True)
    emit("boosted_parity", ok=True, tol=1e-9, cases=out)


# lwfa2d-2048x8192-boosted's deck: bench.py's, translated by +36 um along z
# (window, plasma edge, beam and antenna).  The JAX package's lab snapshot
# domain starts at prob_lo_boost / gamma + c t_lab, about twice the lab
# window's lower edge below it: on bench.py's own window the only lab times
# that fill rows put their planes in the vacuum below the plasma.
LWFA_BOOSTED_SHIFT = (
    ("geometry.prob_lo = -30.e-6 -56.e-6",
     "geometry.prob_lo = -30.e-6 -20.e-6"),
    ("geometry.prob_hi =  30.e-6  12.e-6",
     "geometry.prob_hi =  30.e-6  48.e-6"),
    ("electrons.zmin = -56.e-6", "electrons.zmin = -20.e-6"),
    ("beam.z_m = -28.e-6", "beam.z_m = 8.e-6"),
    ("laser1.position = 0. 0. 9.e-6", "laser1.position = 0. 0. 45.e-6"))


def lwfa_boosted_deck_text(nx, nz, steps):
    """``lwfa_deck_text`` at 'mixed', translated by LWFA_BOOSTED_SHIFT, with
    warpx.gamma_boost = 10 along z."""
    text = lwfa_deck_text(nx, nz, steps, "mixed")
    for old, new in LWFA_BOOSTED_SHIFT:
        if old not in text:
            raise AssertionError(f"bench.py's deck has no {old!r}")
        text = text.replace(old, new)
    return text + BOOST_KEYS


def btd_snapshot_times(cfg, steps):
    """Lab times for a 4-snapshot BackTransformed diagnostic of the boosted
    configuration ``cfg`` over ``steps`` steps: the JAX package's snapshot
    at t_lab fills row k_lab = floor((z_lab - zmin_lab) / dz_lab) while its
    plane z_boost lies in the window, with zmin_lab = prob_lo_boost / gamma
    + v_w c t_lab.  Both conditions bound t_lab linearly at each boosted
    time t; taken at t = 0 and at the last step (the window's lower edge at
    its highest) they give the band [lo, hi) of lab times that keep the
    plane in the window and its row in [0, nz_lab) through the run.
    Returns (d, band): snapshot i at t_lab = i d, 3 d halfway from 0 to the
    band's top (the band must hold 0)."""
    geom = cfg.geometry
    g, c = cfg.gamma_boost, C_LIGHT
    b = (1.0 - 1.0 / g ** 2) ** 0.5
    vw = cfg.moving_window_v
    lo, hi = geom.prob_lo[1], geom.prob_hi[1]
    dz_lab = c * cfg.dt / (b * g)
    nz_lab = int(np.floor((hi - lo) * g * (1.0 - b * vw) / dz_lab))
    span = steps * cfg.dt * c
    lows, highs = [], []
    for t in (0.0, steps * cfg.dt):
        # z_boost = (t_lab / g - t) c / b in [lo + span, hi)
        lows.append((lo + span + c * t / b) * g * b / c)
        highs.append((hi + c * t / b) * g * b / c)
        # k_lab dz_lab = t_lab c (1/b - v_w) - c t / (g b) - lo / g
        slope = c * (1.0 / b - vw)
        lows.append((c * t / (g * b) + lo / g) / slope)
        highs.append((nz_lab * dz_lab + c * t / (g * b) + lo / g) / slope)
    band = (max(lows), min(highs))
    if not band[0] <= 0.0 < band[1]:
        raise AssertionError(f"lab times {band} fill rows: 0 is not among "
                             "them")
    return band[1] / 6, band


class recorded_slices:
    """Within the block, every slice ``BTDSnapshots.update`` takes is kept
    with the step, time and window edge it was taken at (for
    ``btd_independent_check``)."""

    def __enter__(self):
        from warpx_tpu_torch.diagnostics import btd as btd_mod

        self.mod, self.calls = btd_mod, []
        self.orig = btd_mod.cell_centered_slice

        def rec(state, cfg, stag, names, k, *a, **kw):
            raw = self.orig(state, cfg, stag, names, k, *a, **kw)
            self.calls.append((state.step, float(state.time),
                               float(state.aux["window_lo"]), k, raw))
            return raw
        btd_mod.cell_centered_slice = rec
        return self

    def __exit__(self, *exc):
        self.mod.cell_centered_slice = self.orig


def host_back_transform(raw, g, b):
    """JAX btd.py:115-140's formulas in float64 on the host, from the raw
    cell-centered values ``raw`` (name -> float64 array): (the lab-frame
    fields, each field's scale: its terms' magnitudes, since the lab jz
    and rho of a streaming plasma cancel to a small remainder)."""
    c = C_LIGHT
    r = {nm: np.asarray(v, np.float64) for nm, v in raw.items()}
    a = {nm: np.abs(v) for nm, v in r.items()}
    ref = {"Ex": g * (r["Ex"] + b * c * r["By"]),
           "By": g * (r["By"] + b / c * r["Ex"]),
           "Ey": g * (r["Ey"] - b * c * r["Bx"]),
           "Bx": g * (r["Bx"] - b / c * r["Ey"]),
           "Ez": r["Ez"], "Bz": r["Bz"], "jx": r["jx"], "jy": r["jy"],
           "jz": g * (r["jz"] + b * c * r["rho"]),
           "rho": g * (r["rho"] + b / c * r["jz"])}
    size = {"Ex": g * (a["Ex"] + b * c * a["By"]),
            "By": g * (a["By"] + b / c * a["Ex"]),
            "Ey": g * (a["Ey"] + b * c * a["Bx"]),
            "Bx": g * (a["Bx"] + b / c * a["Ey"]),
            "Ez": a["Ez"], "Bz": a["Bz"], "jx": a["jx"], "jy": a["jy"],
            "jz": g * (a["jz"] + b * c * a["rho"]),
            "rho": g * (a["rho"] + b / c * a["jz"])}
    return ref, size


def row_err(row, raw, btd):
    """The worst error of a stored row (fields, transverse...) against
    ``host_back_transform`` of its raw slice, over each field's scale."""
    ref, size = host_back_transform(raw, btd.gamma, btd.beta)
    worst = 0.0
    for fi, nm in enumerate(btd.fields):
        scale = max(float(size[nm].max()), 1e-300)
        worst = max(worst, float(np.abs(row[fi] - ref[nm]).max()) / scale)
    return worst


def btd_independent_check(btd, calls, dz):
    """Every filled row of ``btd`` against an independent back-transform:
    for each recorded slice (step, time, window edge, k_boost, raw), the
    plane and lab row recomputed on the host in float64, and the row that
    the first slice of a lab cell gives from JAX btd.py:115-140's formulas
    in float64 on the host from the raw cell-centered values.  Returns the
    worst error over each field's scale (``row_err``) and the rows
    checked."""
    g, b, c = btd.gamma, btd.beta, C_LIGHT
    worst, checked = 0.0, 0
    for i in range(btd.num):
        ks, rows = btd.rows(i)
        if not ks:
            continue
        stored = dict(zip(ks, rows.double().cpu().numpy()))
        seen = {}
        for step, t, z_lo, k_boost, raw in calls:
            zb = (btd.t_lab[i] / g - t) * c / b
            zl = (btd.t_lab[i] - t / g) * c / b
            k_lab = int(np.floor((zl - btd.zmin_lab[i]) / btd.dz_lab))
            kb = int(np.floor((zb - z_lo) / dz))
            if (kb == k_boost and 0 <= k_lab < btd.nz_lab
                    and k_lab not in seen):
                seen[k_lab] = {nm: v.double().cpu().numpy()
                               for nm, v in raw.items()}
        if set(seen) != set(stored):
            raise AssertionError(f"snapshot {i}: rows {sorted(stored)} "
                                 f"against {sorted(seen)}")
        for k_lab, r in seen.items():
            worst = max(worst, row_err(stored[k_lab], r, btd))
            checked += 1
    return worst, checked


TOL_BTD_ROW = 1e-5


class recorded_occupancy:
    """Within the block, the fullest tile's live particles after each rebin
    of the bounded step (device counts, read after the block)."""

    def __enter__(self):
        from warpx_tpu_torch.core import bounded_step

        self.mod, self.orig, self.peaks = bounded_step, bounded_step.rebin, []

        def rec(sp, geom, spec, **kw):
            new, ovf = self.orig(sp, geom, spec, **kw)
            self.peaks.append(new.alive.reshape(spec.n_tiles, spec.p_max)
                              .sum(dim=1).max())
            return new, ovf
        bounded_step.rebin = rec
        return self

    def __exit__(self, *exc):
        self.mod.rebin = self.orig


def phase_main_lwfa_boosted(dev, smi, k1c_row, k3_row, lab_idle,
                            nx=2048, nz=8192):
    """lwfa2d-2048x8192-boosted: ``lwfa_boosted_deck_text`` (bench.py's deck
    at 'mixed', translated along z, gamma_boost = 10) with one
    BackTransformed diagnostic of 4 snapshots with JAX's default fields
    (rho included), their lab times from ``btd_snapshot_times``;
    tile-binned through K1c and K3 at the default tile headroom, driven as
    main_lwfa is (LWFA_BOOSTED_PLAN, 54 steps), with the fullest tile after
    each rebin
    recorded.  Every filled row holds data (each plane crosses the plasma)
    and matches an independent back-transform (``btd_independent_check``);
    the slab's rho at each plane on the final state against the whole-grid
    deposit; the BTD's work for one row timed alone; the host's waits on
    quiet steps against main_lwfa_deck's (``lab_idle``); K1c at 'mixed' at
    its shapes.  Adds this path's launches to the rows of K1c at 'mixed'
    and K3; returns the timed steps' ms a step."""
    import warpx_tpu_torch
    from warpx_tpu_torch.diagnostics import btd as btd_mod
    from warpx_tpu_torch.diagnostics.fields import (cell_centered_output,
                                                    cell_centered_slice)
    from warpx_tpu_torch.utils.parser import Deck

    steps = lwfa_steps(LWFA_BOOSTED_PLAN)
    text = lwfa_boosted_deck_text(nx, nz, steps)
    probe = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float32, device=dev)
    d, band = btd_snapshot_times(probe.cfg, steps)
    del probe
    out_dir = tempfile.mkdtemp(prefix="btd_main_")
    text += ("diagnostics.diags_names = btd1\n"
             "btd1.diag_type = BackTransformed\n"
             "btd1.num_snapshots_lab = 4\n"
             f"btd1.dt_snapshots_lab = {d!r}\n")
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float32, device=dev,
        output_dir=out_dir)
    (btd,) = sim.btd
    if sim.cfg.gamma_boost != GAMMA_BOOST or not sim.binned:
        raise AssertionError("main_lwfa_boosted: not a boosted binned run")
    with recorded_slices() as rec, recorded_occupancy() as occ:
        launches, anchors, zshift, waits = run_lwfa_path(
            dev, smi, "main_lwfa_boosted", sim, LWFA_BOOSTED_PLAN,
            boosted=True)
    btd.check_overflow()
    spec = sim.tile_spec
    peaks = [int(p) for p in occ.peaks]
    # a tile of the initial plasma: its particles per cell times its cells
    ppc = next(s for s in sim.cfg.species if s.name == "electrons")
    uniform = (int(np.prod(ppc.num_particles_per_cell_each_dim))
               * int(np.prod(sim.cfg.tile_size[-2:])))
    rows = [int(f.sum()) for f in btd.filled]
    with_data = [int((r.abs().amax(dim=tuple(range(1, r.ndim))) > 0).sum())
                 if r is not None else 0
                 for r in (btd.rows(i)[1] for i in range(btd.num))]
    if min(rows) == 0 or max(rows) > steps or with_data != rows:
        raise AssertionError(f"main_lwfa_boosted: BTD rows {rows}, of them "
                             f"{with_data} with data")
    worst, checked = btd_independent_check(btd, rec.calls,
                                           sim.cfg.geometry.dx[1])
    if checked != sum(rows) or worst > TOL_BTD_ROW:
        raise AssertionError(f"BTD rows against the independent transform: "
                             f"{worst} over {checked} of {sum(rows)} rows")
    # the slab's rho at each snapshot's plane on the final state against
    # the whole-grid deposit
    state = sim.state
    whole = cell_centered_output(state, sim.cfg, sim.staggering,
                                 names=["rho"])["rho"]
    t = float(state.time)
    slab_err, ov = {}, []
    for i in range(btd.num):
        zb, _ = btd.plane(i, t)
        k = int(np.floor((zb - float(state.aux["window_lo"]))
                         / sim.cfg.geometry.dx[1]))
        if 0 <= k < sim.cfg.geometry.n_cell[1]:
            for injected in (False, True):
                got = cell_centered_slice(
                    state, sim.cfg, sim.staggering, ["rho"], k, ov,
                    btd.slab_plan(sim, k, injected))["rho"]
                slab_err[f"{i}:{'room' if injected else 'slots'}"] = \
                    rel_err(got, whole[..., k])[1]
    if (len(slab_err) != 2 * btd.num or max(slab_err.values()) > 1e-5
            or any(int(o) for o in ov)):
        raise AssertionError(f"slab rho against the whole grid: {slab_err}")
    k_row = max(0, int(np.floor((btd.plane(3, t)[0]
                                 - float(state.aux["window_lo"]))
                                / sim.cfg.geometry.dx[1])))
    plans = {"slots": btd.slab_plan(sim, k_row, False),
             "room": btd.slab_plan(sim, k_row, True)}

    def one_row(plan):
        raw = cell_centered_slice(state, sim.cfg, sim.staggering,
                                  btd._inputs, k_row, [], plan)
        lab = btd_mod.back_transform(raw, btd.gamma, btd.beta)
        return torch.stack([lab[f] for f in btd.fields])

    row_ms = {how: cuda_ms(lambda: one_row(plan), 5)
              for how, plan in plans.items()}
    whole_ms = cuda_ms(lambda: cell_centered_output(
        state, sim.cfg, sim.staggering, names=["rho"]), 2)
    k1c = k2_window_at_main_shapes(sim, anchors, zshift, mxu="mixed")
    lab_max = max(lab_idle) if lab_idle else 0
    emit("main_lwfa_boosted_btd", snapshots=btd.num,
         dt_snapshots_lab=d, t_lab=btd.t_lab, t_lab_band_filling=band,
         nz_lab=btd.nz_lab, dz_lab=btd.dz_lab, rows_filled=rows,
         rows_checked=checked, row_max_rel_err=worst, row_tol=TOL_BTD_ROW,
         rows_with_data=with_data, slab_rho_rel_err=slab_err,
         ms_per_row=row_ms, rows_per_step=sum(rows) / steps,
         slab_slots={how: {nm: (a.numel() if how == "slots" else a)
                           for nm, (_, a) in plan.items()}
                     for how, plan in plans.items()},
         ms_whole_grid_rho=whole_ms,
         tile_occupancy={"peak_after_each_rebin": peaks,
                         "uniform_plasma": uniform, "p_max": spec.p_max,
                         "tile_headroom": sim.cfg.tile_headroom},
         idle_waits=waits["idle"], lab_idle_waits=lab_idle,
         quiet_step_waits_vs_lab=(max(waits["idle"]) if waits["idle"]
                                  else 0) - lab_max,
         fused_pic_moving_window_mixed={
             k: k1c[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "max_abs_err", "wide_tiles",
                                 "occupied_tiles")},
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    add_launches({"fused_pic_moving_window_mixed": k1c_row,
                  "ragged_expand": k3_row},
                 {"fused_pic_moving_window_mixed": launches["fused_pic_2d"],
                  "ragged_expand": launches["ragged_expand"]},
                 "main_lwfa_boosted")
    shutil.rmtree(out_dir, ignore_errors=True)
    return waits["ms_per_step"]


class timed_bounded_deposits(timed_deposits):
    """``timed_deposits`` for the bounded step's own deposit calls."""

    NAMES = ("deposit_rho", "deposit_current_esirkepov",
             "deposit_current_direct")

    def __enter__(self):
        from warpx_tpu_torch.core import bounded_step

        self.mod, self.calls, self.orig = bounded_step, [], {}
        for nm in self.NAMES:
            fn = self.orig[nm] = getattr(bounded_step, nm)
            setattr(bounded_step, nm, self._timed(nm, fn))
        return self


def phase_main_lwfa_boosted_galilean(dev, smi, nx=2048, nz=8192, steps=6):
    """lwfa2d-2048x8192-boosted-galilean (BASELINE.json configuration 4's
    physics in 2D): bench.py's deck with gamma_boost = 10 under PSATD with
    psatd.use_default_v_galilean = 1 (the grid drifting at -beta c e_z,
    update-with-rho on, PSATD's default direct deposition), per particle
    (the tile-binned gate refuses Galilean PSATD), ``steps`` steps: the
    last ``steps`` - 4 timed with CUDA events, 2 profiled (device busy
    share), one with its deposits and the push timed; finite fields, the
    window moved."""
    import warpx_tpu_torch
    from warpx_tpu_torch.utils.parser import Deck

    text = (lwfa_deck_text(nx, nz, steps, "mixed") + BOOST_KEYS).replace(
        "algo.maxwell_solver = yee",
        "algo.maxwell_solver = psatd\npsatd.use_default_v_galilean = 1"
    ).replace("tpu.tiled_particles = on", "tpu.tiled_particles = off")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float32, device=dev)
    cfg = sim.cfg
    if sim.binned or not any(cfg.psatd_v_galilean) or not (
            cfg.psatd_update_with_rho and cfg.current_deposition == "direct"):
        raise AssertionError("main_lwfa_boosted_galilean's configuration")
    sim.init()
    sim.evolve(1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    timed = steps - 4
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
    marks[0].record()
    for mark in marks[1:]:
        sim.evolve(1)
        mark.record()
    marks[-1].synchronize()
    ms_step = marks[0].elapsed_time(marks[-1]) / timed
    breakdown = profile_steps(sim, 1, top=20)
    with timed_bounded_deposits() as dep:
        sim.evolve(1)
    deposits = dep.report(1)
    st = sim.stepper
    state = sim.state
    kw = dict(dtype=state.fields.Ex.dtype, device=state.fields.Ex.device)
    rho = (torch.zeros(st.shapes["rho"], **kw),) * 2
    push_ms = cuda_ms(lambda: st.psatd_push(state.fields, dict(state.aux),
                                            rho), 2)
    sim.evolve()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if sim.state.step != steps:
        raise AssertionError(f"ended at step {sim.state.step}")
    f = sim.state.fields
    for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz"):
        if not bool(torch.isfinite(getattr(f, nm)).all()):
            raise AssertionError(f"main_lwfa_boosted_galilean: {nm}")
    if not float(sim.state.aux["window_x"]) > cfg.geometry.prob_lo[1]:
        raise AssertionError("the window did not move")
    el = sum(int(sp.alive.sum()) for sp in sim.state.species.values())
    emit("main_lwfa_boosted_galilean", ok=True, n_cell=cfg.geometry.n_cell,
         steps=steps, steps_timed=timed, ms_per_step=ms_step,
         pushes_per_s=el / (ms_step * 1e-3), alive=el,
         v_galilean=cfg.psatd_v_galilean, init_s=init_s,
         device_busy_share=breakdown["device_busy_share"],
         device_ms_per_step=breakdown["device_ms_per_step"],
         deposits=deposits, psatd_push_ms=push_ms, peak_memory_bytes=peak,
         window_offset=int(sim.state.aux["window_offset"]),
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    emit("main_lwfa_boosted_galilean_profile", steps=1, **breakdown)


def phase_main_divclean(dev, smi, n=128, steps=10):
    """uniform-128-divclean: main's plasma and dt (main_cfg) with
    do_dive_cleaning and do_divb_cleaning under Yee, per particle (the
    tile-binned gate refuses cleaning), ``steps`` timed steps: ms a step,
    the rho pair's device ms, max |F| and max |G|; G must stay at
    roundoff, because Yee keeps the discrete div B at zero."""
    cfg = dataclasses.replace(main_cfg(
        n, steps + PROFILED_STEPS_PER_PARTICLE + 3),
                              tiled_particles="off", do_dive_cleaning=True,
                              do_divb_cleaning=True)
    sim = run_per_particle_path(dev, smi, "main_divclean", cfg,
                                2 * 2 * n ** 3, steps)
    f = sim.state.fields
    f_max = float(f.F.abs().max())
    g_max = float(f.G.abs().max())
    b_max = max(float(getattr(f, nm).abs().max())
                for nm in ("Bx", "By", "Bz"))
    # G from a div B of float32 roundoff: c^2 dt eps |B| / dx a step
    g_scale = (C_LIGHT ** 2 * cfg.dt * b_max / min(cfg.geometry.dx)
               * cfg.max_step)
    if not (f_max > 0 and g_max <= 1e-4 * g_scale):
        raise AssertionError(f"main_divclean: max|F| {f_max}, max|G| "
                             f"{g_max} against {g_scale}")
    emit("main_divclean_fg", max_abs_F=f_max, max_abs_G=g_max,
         max_abs_B=b_max, G_roundoff_scale=g_scale,
         G_over_scale=g_max / g_scale, nvidia_smi=smi)


# ---- the output path -------------------------------------------------------

# The outputs main_lwfa_diags adds to bench.py's deck: a plotfile at step 40,
# a checkpoint at 20, the reduced diagnostics every 4 steps, and (where h5py
# is installed) an openPMD file of the beam at 40.
LWFA_DIAGS = """
diagnostics.diags_names = {names}
diag1.intervals = {end}:{end}
diag1.fields_to_plot = Ex Ez By jz rho
diag1.species = electrons beam
chk.format = checkpoint
chk.intervals = {chk}:{chk}
diag2.format = openpmd
diag2.intervals = {end}:{end}
diag2.fields_to_plot = none
diag2.species = beam
warpx.reduced_diags_names = fe fm pe pn px rm br ph
fe.type = FieldEnergy
fm.type = FieldMaximum
pe.type = ParticleEnergy
pn.type = ParticleNumber
px.type = ParticleExtrema
rm.type = RhoMaximum
br.type = BeamRelevant
br.species = beam
ph.type = ParticleHistogram
ph.species = electrons
ph.histogram_function(t,x,y,z,ux,uy,uz) = "uz"
ph.bin_number = 50
ph.bin_min = -0.05
ph.bin_max = 0.05
fe.intervals = 4
fm.intervals = 4
pe.intervals = 4
pn.intervals = 4
px.intervals = 4
rm.intervals = 4
br.intervals = 4
ph.intervals = 4
"""
# 40 steps and the checkpoint at 20 until the script needed the time for
# later phases
DIAGS_STEPS = 24
DIAGS_CHK = 12
# Restarted from step DIAGS_CHK and run to DIAGS_STEPS, the card's run
# differs from the uninterrupted one only in the order of K2's float32
# shared-memory atomics: J differs by up to ~1.5e-7 of itself from launch
# to launch (ROADMAP Queue C), and the steps after the checkpoint carry
# that into the fields and the particles (20 steps in the measurements
# below).  Two runs
# on one NVIDIA H100 80GB HBM3 at 700 W measured 2.1e-8 and 4.7e-7 (the
# spread itself varies by 20x from run to run); 1e-4 leaves a factor 200
# over the larger, and a restart that lost a field, a window scalar or the
# synchronization flag moves the checksums by far more.
TOL_RESTART = 1e-4


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in pathlib.Path(path).rglob("*")
               if f.is_file())


def state_bytes(state) -> int:
    """The bytes of every tensor of a state (a checkpoint's transfer)."""
    tensors = [*vars(state.fields).values(), *state.aux.values()]
    for sp in state.species.values():
        tensors += [t for t in vars(sp).values() if t is not None]
    return sum(t.nelement() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def phase_main_lwfa_diags(dev, smi, k2_row, k3_row, idle_waits, nx=2048,
                          nz=8192):
    """lwfa2d-2048x8192 from bench.py's deck text at 'mixed' with the
    outputs of LWFA_DIAGS, DIAGS_STEPS steps (rebins every 16), as a user
    runs a
    deck with outputs (Simulation.from_deck with an output directory).  It
    checks that the plotfile reads back exactly as the port held it (the
    cell-centered fields and the compacted particle columns, float64 of the
    float32 tensors), that the reduced files have a row every 4 steps and
    ParticleNumber the alive counts, the openPMD beam against the plotfile's
    beam, that a step with no output due waits for the device as often as
    main_lwfa_deck's steps that neither rebin nor inject (``idle_waits``;
    ``quiet_step``), and that a
    fresh simulation restarted from the step-DIAGS_CHK checkpoint and run
    to DIAGS_STEPS
    agrees with the run on every checksum but divE/divB within TOL_RESTART
    (its deck without the plotfile and openPMD outputs, which change no
    step).  It times the plotfile and the checkpoint where the run writes
    them, and the reduced diagnostics and the openPMD file alone on the
    final state.  Adds the run's K2 and K3 launches to ``k2_row`` and
    ``k3_row``."""
    import gc
    import importlib.util
    import shutil

    from warpx_tpu_torch.core import simulation as sim_mod
    from warpx_tpu_torch.core.simulation import Simulation
    from warpx_tpu_torch.diagnostics.reduced import compute_reduced
    from warpx_tpu_torch.io.checkpoint import load_checkpoint
    from warpx_tpu_torch.io.openpmd import write_openpmd_iteration
    from warpx_tpu_torch.io.plotfile import read_particles, read_plotfile
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling
    from warpx_tpu_torch.utils.parser import Deck

    has_h5py = importlib.util.find_spec("h5py") is not None
    names = "diag1 chk diag2" if has_h5py else "diag1 chk"
    text = (lwfa_deck_text(nx, nz, DIAGS_STEPS, "mixed")
            + LWFA_DIAGS.format(names=names, end=DIAGS_STEPS,
                                chk=DIAGS_CHK))
    if not has_h5py:
        # no openPMD diagnostic at all: its keys would be unread
        text = "\n".join(ln for ln in text.splitlines()
                         if not ln.startswith("diag2."))
    restart_text = "\n".join(
        "diagnostics.diags_names = chk" if ln.startswith("diagnostics.")
        else ln for ln in text.splitlines()
        if not ln.startswith(("diag1.", "diag2.")))
    plotfiles, checkpoints = [], []
    save_checkpoint = sim_mod.save_checkpoint

    def timed_checkpoint(path, state, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(path, state, *args)
        checkpoints.append({"ms": (time.perf_counter() - t0) * 1e3,
                            "bytes": dir_bytes(path),
                            "d2h_bytes": state_bytes(state)})

    class Checked(Simulation):
        """The port's Simulation with each plotfile read back right after
        it is written, held against the tensors it was written from, then
        deleted (each is ~2.8 GB)."""

        def _flush_plotfile(self, dg, path, step, fields, select):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._flush_plotfile(dg, path, step, fields, select)
            write_s = time.perf_counter() - t0
            (level,), meta = read_plotfile(path)
            if list(level) != list(fields) or meta["step"] != step:
                raise AssertionError(f"plotfile {path}: {list(level)}")
            for k, v in fields.items():
                if not np.array_equal(level[k], v.double().cpu().numpy()):
                    raise AssertionError(f"plotfile {path}: {k} differs")
            n_cols = 0
            for sp, cols in self.plotfile_particles(dg["species"],
                                                    select).items():
                back = read_particles(path, sp)
                for c, a in cols.items():
                    n_cols += a.size
                    if not np.array_equal(back[c], np.asarray(a, np.float64)):
                        raise AssertionError(f"plotfile {path}: {sp}.{c}")
            plotfiles.append({
                "step": step, "write_s": write_s, "bytes": dir_bytes(path),
                "d2h_bytes": sum(v.nelement() * v.element_size()
                                 for v in fields.values()) + 4 * n_cols})
            shutil.rmtree(path)

    out = pathlib.Path(tempfile.mkdtemp(prefix="lwfa_diags_"))
    try:
        for k in fp.binned_push_deposit.launches_by_mode:
            fp.binned_push_deposit.launches_by_mode[k] = 0
        fp.binned_push_deposit.launches_2d = 0
        tiling.ragged_expand.launches = 0
        sim = Checked.from_deck(Deck.from_string(text), dtype=torch.float32,
                                device=dev, output_dir=str(out / "run"))
        sim_mod.save_checkpoint = timed_checkpoint
        t0 = time.perf_counter()
        sim.init()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_el = int(sim.state.species["electrons"].alive.sum())
        chk_bytes = state_bytes(sim.state)
        plot_bytes = 8 * (5 * nx * nz + 6 * 2 * n_el)
        free = shutil.disk_usage(out).free
        if free < 2 * (chk_bytes + plot_bytes):
            raise AssertionError(f"{free} bytes free under {out}, "
                                 f"{2 * (chk_bytes + plot_bytes)} needed")
        interval = sim.cfg.sort_interval
        outputs = sim.reduced + sim.diags
        step_s, due_steps, waits = {}, {}, {}
        while sim.state.step < DIAGS_STEPS:
            s0 = sim.state.step
            due = sorted(o["name"] for o in outputs
                         if o["intervals"].contains(s0 + 1))
            if (not due and quiet_step(s0, interval)
                    and s0 >= DIAGS_STEPS // 2 and len(waits) < 3):
                waits[s0 + 1] = count_device_waits(lambda: sim.evolve(1))
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.evolve(1)
            torch.cuda.synchronize()
            step_s[s0 + 1] = time.perf_counter() - t0
            due_steps[s0 + 1] = due
        launches = {"fused_pic_2d": fp.binned_push_deposit.launches_2d,
                    "ragged_expand": tiling.ragged_expand.launches}
        rebins = len(range(0, DIAGS_STEPS, interval))
        if (launches != {"fused_pic_2d": DIAGS_STEPS, "ragged_expand": rebins}
                or fp.binned_push_deposit.launches_by_mode["mixed"]
                != DIAGS_STEPS):
            raise AssertionError(f"main_lwfa_diags launched {launches}")
        if sorted(set(waits.values())) != idle_waits:
            raise AssertionError(f"steps with no output due waited {waits} "
                                 f"times; main_lwfa_deck's idle steps "
                                 f"{idle_waits}")
        sim_mod.save_checkpoint = save_checkpoint
        if [p["step"] for p in plotfiles] != [DIAGS_STEPS]:
            raise AssertionError(f"plotfiles at {plotfiles}")
        if (not (out / "run" / f"chk{DIAGS_CHK:06d}" / "state.npz").exists()
                or len(checkpoints) != 1):
            raise AssertionError(f"checkpoints {checkpoints}, not one at "
                                 f"step {DIAGS_CHK}")
        alive = {nm: int(sp.alive.sum())
                 for nm, sp in sim.state.species.items()}
        reduced_rows = {}
        for rd in sim.reduced:
            lines = pathlib.Path(rd["writer"].path).read_text().splitlines()
            rows = [ln.split(",") for ln in lines[1:]]
            if [int(r[0]) for r in rows] != list(range(4, DIAGS_STEPS + 1,
                                                       4)):
                raise AssertionError(f"{rd['name']}: rows {len(rows)}")
            reduced_rows[rd["name"]] = dict(zip(
                lines[0].lstrip("#").split(","), rows[-1]))
        last = {k.split("]", 1)[1]: float(v)
                for k, v in reduced_rows["pn"].items()}
        for nm in ("electrons", "beam"):
            if last[f"{nm}_macroparticles()"] != alive[nm]:
                raise AssertionError(f"ParticleNumber {nm}: {last}, "
                                     f"alive {alive}")
        if has_h5py:
            import h5py

            cols = sim.plotfile_particles(["beam"])["beam"]
            with h5py.File(out / "run" / "diag2.h5") as fh:
                grp = fh[f"data/{DIAGS_STEPS}/particles/beam"]
                got = {"x": grp["position/x"][...],
                       "y": grp["position/z"][...],
                       "weight": grp["weighting/value"][...],
                       **{f"momentum_{c}": grp[f"momentum/{c}"][...]
                          for c in "xyz"}}
            for c, a in cols.items():
                if not np.array_equal(np.asarray(got[c], np.float64),
                                      np.asarray(a, np.float64)):
                    raise AssertionError(f"openPMD beam {c} differs")
        sums = sim.checksums()

        # each flush kind alone on the final state
        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        alone = out / "alone"
        flush = {}
        by_kind = {rd["kind"]: timed(lambda: compute_reduced(
            rd["kind"], sim.state, sim.cfg, sim.staggering,
            params=rd["params"])) for rd in sim.reduced}
        flush["reduced"] = {
            "ms": sum(by_kind.values()), "ms_by_kind": by_kind,
            "bytes_a_row": sum(len(",".join(r.values())) + 1
                               for r in reduced_rows.values()),
            "d2h_bytes": 8 * sum(len(r) - 2 for r in reduced_rows.values())}
        flush["plotfile"] = {"ms": plotfiles[-1]["write_s"] * 1e3,
                             "step": DIAGS_STEPS,
                             "bytes": plotfiles[-1]["bytes"],
                             "d2h_bytes": plotfiles[-1]["d2h_bytes"]}
        flush["checkpoint"] = {**checkpoints[0], "step": DIAGS_CHK}
        if has_h5py:
            flush["openpmd"] = {"ms": timed(lambda: write_openpmd_iteration(
                str(alone / "beam.h5"), DIAGS_STEPS, sim.state, sim.cfg, {},
                sim.state.time, sim.cfg.dt, [0.0, 0.0],
                species_names=["beam"])),
                "bytes": dir_bytes(alone), "d2h_bytes": 4 * 6 * alive["beam"]}
        flush_steps = {s: t for s, t in step_s.items() if due_steps[s]}
        idle_steps = {s: t for s, t in step_s.items()
                      if not due_steps[s] and quiet_step(s - 1, interval)}
        del sim
        gc.collect()
        torch.cuda.empty_cache()

        sim = Simulation.from_deck(Deck.from_string(restart_text),
                                   dtype=torch.float32, device=dev,
                                   output_dir=str(out / "restart"))
        sim.init()
        sim.state, sim.is_synchronized = load_checkpoint(
            str(out / "run" / f"chk{DIAGS_CHK:06d}"), sim.state)
        if sim.state.step != DIAGS_CHK:
            raise AssertionError(f"restarted at step {sim.state.step}")
        sim.evolve()
        restarted = sim.checksums()
        restart_err = checksums_agree(restarted, sums, TOL_RESTART,
                                      "restart vs uninterrupted")
        worst_of = max(((g, q) for g in sums for q in sums[g]
                        if q not in ("divE", "divB") and sums[g][q]),
                       key=lambda k: abs(restarted[k[0]][k[1]]
                                         - sums[k[0]][k[1]])
                       / abs(sums[k[0]][k[1]]))
        del sim
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        sim_mod.save_checkpoint = save_checkpoint
        shutil.rmtree(out, ignore_errors=True)
    add_launches({"fused_pic_2d": k2_row, "ragged_expand": k3_row}, launches,
                 "main_lwfa_diags")
    emit("main_lwfa_diags", ok=True, n_cell=[nx, nz], steps=DIAGS_STEPS,
         h5py=has_h5py, alive_at_end=alive, launches=launches,
         init_s=init_s, plotfiles_read_back_exactly=plotfiles,
         flush_alone=flush,
         s_a_step_with_outputs=flush_steps, outputs_due=due_steps,
         s_a_step_without=idle_steps,
         mean_s_idle=sum(idle_steps.values()) / max(len(idle_steps), 1),
         device_waits_idle_steps=waits, main_lwfa_deck_idle=idle_waits,
         restart={"from_step": DIAGS_CHK, "to_step": DIAGS_STEPS,
                  "max_rel_err": restart_err, "tol": TOL_RESTART,
                  "worst": "/".join(worst_of)},
         checksum_jz=sums["lev=0"]["jz"], nvidia_smi=smi)


def phase_deck_parity(dev):
    """tests/test_binned_bounded.py's 32 x 64 laser-wakefield deck at
    tpu.tile_mxu = mixed through Simulation.from_deck, float64, on the card
    (K2 at 'mixed', once a step) and on the CPU (plain versions), 12 steps:
    every checksum but divE/divB within 1e-9.  Then the CLI as a process of
    its own on the card, on the same deck with --steps 4 --checksums: its
    printed checksums against an in-process run of 4 steps, within 1e-12
    (the J windows' shared-memory atomics sum in an order that changes from
    run to run)."""
    import warpx_tpu_torch
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.utils.parser import Deck

    text = LWFA_32X64_DECK + "\ntpu.tiled_particles = on\ntpu.tile_mxu = mixed\n"
    by_mode = fp.binned_push_deposit.launches_by_mode
    sums = {}
    before = by_mode["mixed"]
    for device in (dev, "cpu"):
        sim = warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(text), dtype=torch.float64, device=device)
        if not (sim.is_bounded and sim.binned and sim.cfg.tile_mxu == "mixed"):
            raise AssertionError("the deck did not take the bounded "
                                 "tile-binned step at 'mixed'")
        sim.init()
        sim.evolve()
        sums[str(device)] = sim.checksums()
        if device is dev:
            launched = by_mode["mixed"] - before
    if launched != sim.cfg.max_step:
        raise AssertionError(f"{launched} launches of K2 at 'mixed' in "
                             f"{sim.cfg.max_step} steps")
    worst = checksums_agree(sums[str(dev)], sums["cpu"], 1e-9,
                            "deck card vs CPU")
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "inputs"
        path.write_text(text)
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "warpx_tpu_torch", str(path), "--steps",
             "4", "--checksums"], capture_output=True, text=True, timeout=600,
            cwd=pathlib.Path(__file__).resolve().parent)
        cli_s = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"the CLI failed: {run.stderr[-2000:]}")
        printed = json.loads(run.stdout[run.stdout.index("\n") + 1:])
        sim = warpx_tpu_torch.Simulation.from_deck(
            str(path), dtype=torch.float64, device=dev)
        sim.init()
        sim.evolve(4)
        cli_err = checksums_agree(printed, sim.checksums(), 1e-12,
                                  "CLI vs in-process")
    emit("deck_parity", ok=True, tol=1e-9, steps=12, max_rel_err=worst,
         k2_mixed_launches=launched, cli={
             "steps": 4, "max_rel_err": cli_err, "tol": 1e-12,
             "seconds": cli_s, "first_line": run.stdout.splitlines()[0]})


# ---- the Hopper labs (warpx_tpu_torch/tools/) ------------------------------

# tile_dot (L3, L4) against its plain version, relative to the largest
# output: both add reps products, each a float32 sum of K exact products
# (bfloat16 operands, or float32 in both) taken in another order (the
# tensor cores' float32 accumulation also truncates), which a sequential
# sum bounds by ~K 2^-24 (7e-5 at K = 1152); random rounding keeps it near
# sqrt(K) 2^-24 (2e-6).
TOL_DOT = 1e-4
# lab_widelane (L2): exact bfloat16 products, float32 sums of up to W^2
# (gather) or P (deposit) terms in another order.
TOL_WIDELANE = 1e-5
# lab_fused (L1), per output: the particles (their fields are float32 sums
# of W^2 exact bfloat16 products, or float32 FMA sums, in another order) and
# the J windows.  J's bands are differences over a drift of ~1e-4 cells, so
# an ulp of a particle's field moves x_new across a float32 rounding now and
# then, which changes that particle's df by ~1e-3 of itself; where the
# deposit's operands are rounded to bfloat16 such a change can also cross a
# bfloat16 rounding boundary (2^-8 of that operand).
TOL_LAB_FUSED = {"particles": 1e-5, "j_f32": 1e-4, "j_bf16": 4e-3}
# Each lab at its own shapes (`labs`), relative to the largest output.  The
# sums are longer than lab_parity's: L1 adds 32 chunks of 64 particles into
# J, and L3 and L4 add the same product reps times (400 in L3, up to 16384
# in L4), where the accumulator's rounding is systematic, up to
# reps 2^-24 of it (L4 at M = 8: 9.8e-4).  Each limit stays below the
# difference a lower precision makes: bfloat16 operands against float32
# move L1's outputs ('full' against 'prec_xx') and L3/L4's zero-mean
# products by more than 1e-3 (the tests *_limit*_sees_bf16_operands in
# tests/test_torch_labs_*.py).  L5 moves values and must be exact.
TOL_LABS = {"L1": 1e-4, "L2": 1e-4, "L3": 1e-4, "L4": 1e-3, "L5": 0.0}


def lab_err(got, ref):
    d = (got.double() - ref.double()).abs().max().item()
    s = ref.double().abs().max().item()
    return d, (d / s if s else d)


# the plan's edge shapes (batch, m, k, n), both layouts: K not a multiple
# of the plan's slice, n not a multiple of 64 (and below it: NT's mma
# path), M = 8 and 40
NT_EDGE_SHAPES = ((2, 8, 1000, 200), (2, 40, 1000, 72), (3, 16, 52, 130),
                  (5, 16, 264, 16))
# layout NN's out = a . b path (m >= 64): m not a multiple of 64 with K not
# a multiple of the slice, K split over blocks, and N = 128 columns
NN_EDGE_SHAPES = ((2, 72, 1000, 200), (2, 128, 2048, 256), (8, 64, 256, 2048))


def phase_lab_parity(dev):
    """Each lab kernel against its plain version at small shapes, every
    mode and both layouts, each case launched three times: L5 exactly (and
    its wrapper refuses rows that are not 16-byte aligned), L3/L4 within
    TOL_DOT (both layouts also at NT_EDGE_SHAPES and at 1, 2 and 4 reps,
    NN at NN_EDGE_SHAPES; each plan's shared memory the kernel's; plans the
    planner does not make: NN on out^T at m = 128 and NT on out = a . b^T
    served, mma in layout NN refused), L2 within
    TOL_WIDELANE at W 16 and 8, L1 within TOL_LAB_FUSED at W 16 and 8, P a
    multiple of its chunk and not (and its wrapper refuses P not a multiple
    of 64)."""
    from warpx_tpu_torch import build
    from warpx_tpu_torch.tools import bench_dot_shapes as dots
    from warpx_tpu_torch.tools import kernel_lab as l1
    from warpx_tpu_torch.tools import lab_widelane as l2
    from warpx_tpu_torch.tools import profile_rebin_lwfa as l5

    launches = 3
    out = {}
    # L5: random offsets (bulk copies of the enclosing aligned ranges,
    # shifted), for a payload whose length is and one whose length is not a
    # multiple of 4 (padded to 16-byte rows by l5.pad); then a row of
    # 50,513 floats, which the wrapper must refuse
    cases = []
    for cap in (50_000, 50_001):
        ps, ks = l5.inputs(cap, 96, 5, dev)
        offsets, counts = l5.prelude(ks, 96)
        psp = l5.pad(ps, 512)
        ref = l5.slot_copy_plain(psp, offsets, counts, 512)
        for _ in range(launches):
            got = l5.slot_copy(psp, offsets, counts, 512)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"slot_copy (cap {cap}) differs from "
                                     "its plain version")
        cases.append({"cap": cap, "row_len": psp.shape[1], "equal": True})
    try:
        l5.slot_copy(psp[:, :50_513].contiguous(), offsets, counts, 512)
    except ValueError:
        pass
    else:
        raise AssertionError("slot_copy took a row that is not 16-byte "
                             "aligned")
    out["L5"] = {"cases": cases, "misaligned_row_refused": True}
    # L3/L4: both layouts, every mode, both operand types, padded rows
    gen = torch.Generator().manual_seed(4)
    worst = 0.0
    cases = []
    shapes = ((3, 8, 64, 40), (2, 16, 1152, 256), (2, 40, 256, 64))
    lib = build.library("tile_dot")
    runs = [(layout, shape, 3) for layout in ("nn", "nt")
            for shape in shapes + NT_EDGE_SHAPES
            + (NN_EDGE_SHAPES if layout == "nn" else ())]
    # the wgmma paths' two accumulators: an odd and an even number of reps,
    # and 1
    runs += [(layout, (3, 16, 52, 130), reps) for layout in ("nn", "nt")
             for reps in (1, 2, 4)]
    for layout, (batch, m, k, n), reps in runs:
        for mode in ("f32", "bf16", "3pass"):
            plan = dots._plan_nt(batch, m, n, k, mode, layout)
            smem = lib.tile_dot_smem(
                m, n, dots.MODES[mode], dots.NT_PATHS[plan["path"]],
                plan["tr"], plan["tc"], plan["rm"], plan["kw"], plan["wb"])
            if smem != plan["smem"]:
                raise AssertionError(f"tile_dot {layout} plan {plan}: the "
                                     f"kernel stages {smem} bytes")
            for dtype in (torch.float32, torch.bfloat16):
                bshape = (batch, k, n) if layout == "nn" else (batch, n, k)
                # zero-mean, so that a lower precision shows
                a = (torch.rand((batch, m, k), generator=gen)
                     - 0.5).to(dev, dtype)
                b = (torch.rand(bshape, generator=gen) - 0.5).to(dev, dtype)
                ref = dots.tile_dot_plain(a, b, reps, mode, layout)
                for _ in range(launches):
                    got = dots.tile_dot(a, b, reps, mode, layout)
                    e = lab_err(got, ref)[1]
                    worst = max(worst, e)
                    if e > TOL_DOT:
                        raise AssertionError(
                            f"tile_dot {layout} {mode} {dtype} "
                            f"({batch}, {m}, {k}, {n}) x {reps}: {e}")
                cases.append({"layout": layout, "mode": mode,
                              "operands": str(dtype), "shape":
                              (batch, m, k, n), "reps": reps, "rel_err": e,
                              "path": plan["path"]})
    # plans the planner does not make, which the kernels serve: NN on
    # out^T with N = m = 128, NT on out = a . b^T (m = 72: a padded unit);
    # and one they refuse: mma in layout NN
    stream = torch.cuda.current_stream(dev).cuda_stream
    forced = (("nn", (2, 128, 256, 200), dict(path="wgmma", kw=64, wb=2,
                                               kb=2, tc=0)),
              ("nt", (2, 72, 200, 130), dict(path="wgmma_n", kw=64, wb=1,
                                              kb=4, tc=8)),
              ("nn", (2, 16, 64, 16), dict(path="mma", kw=64, wb=1, kb=1,
                                            tc=0)))
    for layout, (batch, m, k, n), plan in forced:
        for mode in ("bf16", "3pass"):
            bshape = (batch, k, n) if layout == "nn" else (batch, n, k)
            a = (torch.rand((batch, m, k), generator=gen) - 0.5).to(dev)
            b = (torch.rand(bshape, generator=gen) - 0.5).to(dev)
            got = torch.full((batch, m, n), float("nan"), device=dev)
            scratch = torch.empty((plan["kb"], batch, m, n), device=dev)
            err = lib.tile_dot_launch(
                int(layout == "nn"), a.data_ptr(), b.data_ptr(),
                got.data_ptr(), scratch.data_ptr(), batch, m, k, n, 0,
                dots.MODES[mode], 3, dots.NT_PATHS[plan["path"]], 0,
                plan["tc"], 0, plan["kw"], plan["wb"], plan["kb"], stream)
            torch.cuda.synchronize()
            if plan["path"] == "mma":
                if err == 0:
                    raise AssertionError("tile_dot took path mma in layout "
                                         "NN")
                continue
            e = lab_err(got, dots.tile_dot_plain(a, b, 3, mode, layout))[1]
            worst = max(worst, e)
            if err or not e <= TOL_DOT:
                raise AssertionError(f"tile_dot {layout} {mode} forced plan "
                                     f"{plan} ({batch}, {m}, {k}, {n}): "
                                     f"error {err}, rel err {e}")
            cases.append({"layout": layout, "mode": mode, "shape":
                          (batch, m, k, n), "reps": 3, "rel_err": e,
                          "path": plan["path"], "forced": True})
    out["L3_L4"] = {"worst_rel_err": worst, "tol": TOL_DOT,
                    "nn_mma_refused": True,
                    "cases": len(cases), "paths": {
                        lay: sorted({c["path"] for c in cases
                                     if c["layout"] == lay})
                        for lay in ("nn", "nt")}}
    # L2: both layouts, both deposit precisions, W 16 and 8
    worst = {}
    for w in (16, 8):
        for mode in ("batched", "wide"):
            for dep in ("bf16", "f32"):
                # P = 320 wide: an odd number of the kernel's chunks
                p = 256 if mode == "batched" else 320
                fn, args = l2.make(mode, dep, dev, nt=5, w=w, p=p, seed=w)
                ref = l2.widelane_plain(*args, mode == "batched", dep)
                for _ in range(launches):
                    got = fn(*args)
                    for nm, x, y in zip(("out", "jw"), got, ref):
                        e = lab_err(x, y)[1]
                        key = f"W{w}/{mode}/{dep}/{nm}"
                        worst[key] = max(worst.get(key, 0.0), e)
                        if e > TOL_WIDELANE:
                            raise AssertionError(f"lab_widelane {key}: {e}")
    out["L2"] = {"worst_rel_err": worst, "tol": TOL_WIDELANE}
    # L1: every mode, unpacked and packed, W 16 and 8, P a multiple of the
    # kernel's chunk (256) and not (320 at W 16: nomxu needs P >= W^2; 192
    # at W 8)
    if build.library("lab_fused").lab_fused_chunk() != l1.CHUNK:
        raise AssertionError("kernel_lab.CHUNK is not lab_fused.cu's")
    worst = {}
    runs = ([(m, 16, 320) for m in l1.MODES] + [(m, 8, 192) for m in l1.MODES]
            + [("full", 16, 256), ("nomxu", 8, 256)])
    for mode, w, p in runs:
        for packed in (False, True):
            name = f"pk_{mode}" if packed else mode
            wins, parts, _ = l1.inputs(name, nt=3, w=w, p=p, seed=11,
                                       device=dev)
            ref = l1.lab_fused_plain(name, wins, parts, packed)
            spec = l1.mode_spec(name)
            tol_j = TOL_LAB_FUSED["j_bf16" if spec["deposit"] == "bf16"
                                  else "j_f32"]
            for _ in range(launches):
                got = l1.lab_fused(name, wins, parts, packed)
                if packed:
                    pairs = [("particles", got[0], ref[0]),
                             ("j", got[1], ref[1])]
                else:
                    pairs = ([("particles", x, y) for x, y in zip(got[0],
                                                                  ref[0])]
                             + [("j", x, y)
                                for x, y in zip(got[1], ref[1])])
                for kind, x, y in pairs:
                    e = lab_err(x, y)[1]
                    key = f"W{w}/P{p}/{name}/{kind}"
                    worst[key] = max(worst.get(key, 0.0), e)
                    tol = (TOL_LAB_FUSED["particles"]
                           if kind == "particles" else tol_j)
                    if e > tol:
                        raise AssertionError(
                            f"lab_fused {key}: {e} > {tol}")
    wins, parts, _ = l1.inputs("full", nt=2, w=16, p=200, device=dev)
    try:
        l1.lab_fused("full", wins, parts)
    except ValueError:
        pass
    else:
        raise AssertionError("lab_fused took P = 200, not a multiple of 64")
    out["L1"] = {"worst_rel_err": worst, "tol": TOL_LAB_FUSED,
                 "p_not_multiple_of_64_refused": True}
    emit("lab_parity", ok=True, launches_per_case=launches, **out)


def lab_row(name, source, replaces, case, launches, lib, kernel,
            blocks_per_sm):
    """A kernels-line row from a lab's principal case, with the kernel's
    registers and spill bytes (ptxas's report in library ``lib``'s build
    log, the entry whose name holds ``kernel``) and resident blocks per
    SM (and L4's stacked library product, where the case has it)."""
    from warpx_tpu_torch import build

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms") + (("library_stacked_ms",)
                             if "library_stacked_ms" in case else ())
    regs, spills = ptxas_report(build.build_log(lib))
    entry = [nm for nm in regs if kernel in nm]
    if len(entry) != 1 or entry[0] not in spills:
        raise AssertionError(f"no ptxas report for {kernel} in {lib}'s log")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            **{k: case[k] for k in keys}, "case": case["lab"],
            "registers": regs[entry[0]], "spills": spills[entry[0]],
            "blocks_per_sm": blocks_per_sm}


def phase_labs(dev):
    """Each lab's main() at the TPU lab's default shapes (L1 in every mode),
    with the labs' launch counters set to 0 just before and read just after
    (launches made by lab_parity do not count); each lab prints its lines
    and one JSON line.  Returns the kernels-line rows of L1-L5."""
    from warpx_tpu_torch.tools import bench_deposit_prec as l3
    from warpx_tpu_torch.tools import bench_dot_shapes as l4
    from warpx_tpu_torch.tools import kernel_lab as l1
    from warpx_tpu_torch.tools import lab_widelane as l2
    from warpx_tpu_torch.tools import profile_rebin_lwfa as l5

    counters = ((l1.lab_fused, "L1"), (l2.widelane, "L2"),
                (l4.tile_dot, "L3/L4"), (l5.slot_copy, "L5"))
    for fn, _ in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    res = {"L5": l5.main([])}
    n5 = l5.slot_copy.launches
    res["L4"] = l4.main([])
    n4 = l4.tile_dot.launches
    res["L3"] = l3.main([])
    n3 = l4.tile_dot.launches - n4
    res["L1"] = l1.main(list(l1.MODES) + ["pk_full", "pk_empty"])
    res["L2"] = l2.main([])
    seconds = time.perf_counter() - t0
    launches = {"L1": l1.lab_fused.launches, "L2": l2.widelane.launches,
                "L3": n3, "L4": n4, "L5": n5}
    if not all(launches.values()):
        raise AssertionError(f"a lab kernel never ran: {launches}")
    for lab in ("L1", "L2", "L3", "L4", "L5"):
        for case in res[lab]["cases"]:
            rel = case.get("max_rel_err", case["max_abs_err"])
            if isinstance(rel, dict):
                rel = max(rel.values())
            if not rel <= TOL_LABS[lab]:
                raise AssertionError(f"{case['lab']} disagrees with its "
                                     f"plain version: {case}")
    emit("labs", ok=True, seconds=seconds, launches=launches, tol=TOL_LABS,
         reps_scaling_x4={"L4": res["L4"]["reps_scaling_x4"],
                          "L3": res["L3"]["reps_scaling_x4"]})
    from warpx_tpu_torch import build

    full = next(c for c in res["L1"]["cases"] if c["mode"] == "full")
    c3, c4 = res["L3"]["cases"][0], res["L4"]["cases"][0]
    p3 = l4._plan_nt(c3["batch"], c3["m"], c3["n"], c3["k"], c3["mode"])
    p4 = l4._plan_nt(c4["batch"], c4["m"], c4["n"], c4["k"], c4["mode"],
                     "nn")
    lib4 = build.library("tile_dot")
    bps3 = lib4.tile_dot_blocks_per_sm(
        c3["m"], c3["n"], 0, l4.MODES[c3["mode"]], l4.NT_PATHS[p3["path"]],
        p3["tr"], p3["tc"], p3["rm"], p3["kw"], p3["wb"])
    bps4 = lib4.tile_dot_blocks_per_sm(
        c4["m"], c4["n"], 0, l4.MODES[c4["mode"]], l4.NT_PATHS[p4["path"]],
        p4["tr"], p4["tc"], p4["rm"], p4["kw"], p4["wb"])
    c2 = res["L2"]["cases"][0]
    c5 = res["L5"]["cases"][0]
    return [
        lab_row("lab_fused", "warpx_tpu_torch/csrc/lab_fused.cu",
                "tools/kernel_lab.py:289", full, launches["L1"], "lab_fused",
                f"lab_fused_kernelILi{l1.W}ELi{l1.CHUNK}ELi{l1.WARPS}ELi0ELb0E",
                l1.resources("full", l1.W)["blocks_per_sm"]),
        lab_row("lab_widelane", "warpx_tpu_torch/csrc/lab_widelane.cu",
                "tools/lab_widelane.py:158", c2, launches["L2"],
                "lab_widelane", "lab_widelane_kernelILi{}ELb{}E".format(
                    c2["w"], int(c2["dep"] == "f32")),
                build.library("lab_widelane").lab_widelane_blocks_per_sm(
                    c2["w"], int(c2["dep"] == "f32"))),
        lab_row("tile_dot_deposit_prec", "warpx_tpu_torch/csrc/tile_dot.cu",
                "tools/bench_deposit_prec.py:69", c3, launches["L3"],
                "tile_dot", "tile_dot_fmaIfLi{}ELi{}ELi{}EE".format(
                    p3["tr"], p3["tc"], p3["rm"]), bps3),
        lab_row("tile_dot_shapes", "warpx_tpu_torch/csrc/tile_dot.cu",
                "tools/bench_dot_shapes.py:40", c4, launches["L4"],
                "tile_dot", "tile_dot_wgmmaIfLi{}EE".format(
                    p4["tm"] if p4["path"] == "wgmma" else p4["tn"]), bps4),
        lab_row("slot_copy", "warpx_tpu_torch/csrc/slot_copy.cu",
                "tools/profile_rebin_lwfa.py:338", c5, launches["L5"],
                "slot_copy", "slot_copy_bulk",
                build.library("slot_copy").slot_copy_blocks_per_sm(
                    l5.N_ATTR, c5["pmax"])),
    ]



# ---- the stochastic operators: ionization, QED, resampling -----------------
#
# Copies of the decks tests/test_torch_draws_util.py, test_torch_qed.py,
# test_torch_radiation_reaction.py and test_torch_resampling.py run (this
# script imports neither JAX nor the tests; test_torch_deck.py holds the
# copies equal).

ION_2D_DECK = """
max_step = 6
amr.n_cell = 16 16
geometry.dims = 2
geometry.prob_lo = -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6
particles.species_names = electrons ions eprod
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1
electrons.profile = constant
electrons.density = 1.e24
ions.species_type = nitrogen
ions.injection_style = NUniformPerCell
ions.num_particles_per_cell_each_dim = 2 2
ions.profile = constant
ions.density = 1.e22
ions.do_field_ionization = 1
ions.physical_element = N
ions.ionization_initial_level = 2
ions.ionization_product_species = eprod
eprod.species_type = electron
eprod.injection_style = none
"""


def lwfa_nitrogen_deck(base, steps=8, level=2):
    """The laser-wakefield deck ``base`` with a nitrogen dopant around the
    32 x 64 deck's antenna (initial level ``level``, electrons into
    ``electrons_n``), the laser's peak 6 fs into the run, per particle."""
    return base.replace("max_step = 12", f"max_step = {steps}").replace(
        "particles.species_names = electrons beam",
        "particles.species_names = electrons beam nitrogen electrons_n",
    ).replace("laser1.profile_t_peak = 30.e-15",
              "laser1.profile_t_peak = 6.e-15") + f"""
nitrogen.species_type = nitrogen
nitrogen.injection_style = NUniformPerCell
nitrogen.num_particles_per_cell_each_dim = 2 2
nitrogen.xmin = -10.e-6
nitrogen.xmax = 10.e-6
nitrogen.zmin = -13.e-6
nitrogen.zmax = -7.e-6
nitrogen.profile = constant
nitrogen.density = 2.e21
nitrogen.do_field_ionization = 1
nitrogen.physical_element = N
nitrogen.ionization_initial_level = {level}
nitrogen.ionization_product_species = electrons_n
electrons_n.species_type = electron
electrons_n.injection_style = none
tpu.tiled_particles = off
"""


QED_FIELDS = """
particles.E_ext_particle_init_style = constant
particles.B_ext_particle_init_style = constant
particles.E_external_particle = -2433321316961438.0 973328526784575.0 1459992790176863.0
particles.B_external_particle = 2857142.85714286 4285714.28571428 8571428.57142857
"""
# the same fields (tests/test_qed.py E_f, B_f) for the host evaluations
E_F = np.array([-2433321316961438.0, 973328526784575.0, 1459992790176863.0])
B_F = np.array([2857142.85714286, 4285714.28571428, 8571428.57142857])


def qed_deck(ppc=2, steps=3, n=16, u_lep=100.0, u_phot=1000.0, dt=5e-17):
    """A periodic 2D box under the QED decks' fields: ``ele1`` emits
    photons into ``phot1``; photons ``g1`` make pairs into ``bwe`` (which
    itself emits into ``phot1``) and ``bwp``."""
    return f"""
max_step = {steps}
amr.n_cell = {n} {n}
geometry.dims = 2
geometry.prob_lo = -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6
warpx.const_dt = {dt}
particles.species_names = ele1 phot1 g1 bwe bwp
ele1.species_type = electron
ele1.injection_style = NUniformPerCell
ele1.num_particles_per_cell_each_dim = {ppc} {ppc}
ele1.profile = constant
ele1.density = 1.e2
ele1.momentum_distribution_type = constant
ele1.uy = {u_lep}
ele1.do_qed_quantum_sync = 1
ele1.qed_quantum_sync_phot_product_species = phot1
phot1.species_type = photon
phot1.injection_style = none
g1.species_type = photon
g1.injection_style = NUniformPerCell
g1.num_particles_per_cell_each_dim = {ppc} {ppc}
g1.profile = constant
g1.density = 1.e2
g1.momentum_distribution_type = constant
g1.uz = {u_phot}
g1.do_qed_breit_wheeler = 1
g1.qed_breit_wheeler_ele_product_species = bwe
g1.qed_breit_wheeler_pos_product_species = bwp
bwe.species_type = electron
bwe.injection_style = none
bwe.do_qed_quantum_sync = 1
bwe.qed_quantum_sync_phot_product_species = phot1
bwp.species_type = positron
bwp.injection_style = none
""" + QED_FIELDS


def schwinger_deck(threshold=25.0, steps=2):
    """An 8^3 periodic box with Schwinger pair creation into ``es`` and
    ``ps`` (its field is written after init)."""
    return f"""
max_step = {steps}
amr.n_cell = 8 8 8
geometry.dims = 3
geometry.prob_lo = -4.e-7 -4.e-7 -4.e-7
geometry.prob_hi =  4.e-7  4.e-7  4.e-7
warpx.use_filter = 0
warpx.do_qed_schwinger = 1
qed_schwinger.ele_product_species = es
qed_schwinger.pos_product_species = ps
qed_schwinger.threshold_poisson_gaussian = {threshold}
qed_schwinger.zmin = -2.e-7
qed_schwinger.zmax = 2.e-7
particles.species_names = es ps
es.species_type = electron
es.injection_style = none
ps.species_type = positron
ps.injection_style = none
"""


RR_PERIODIC_DECK = """
max_step = 5
amr.n_cell = 16 16
geometry.dims = 2
geometry.prob_lo = -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6
warpx.const_dt = 2.e-17
particles.species_names = electrons photons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 2 2
electrons.profile = constant
electrons.density = 1.e20
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 300.
electrons.uy_th = 300.
electrons.uz_th = 300.
electrons.do_classical_radiation_reaction = 1
photons.species_type = photon
photons.injection_style = NUniformPerCell
photons.num_particles_per_cell_each_dim = 1 1
photons.profile = constant
photons.density = 1.e20
photons.momentum_distribution_type = gaussian
photons.ux_th = 1000.
photons.uy_th = 1000.
photons.uz_th = 1000.
""" + QED_FIELDS

RESAMPLE_3D_DECK = """
max_step = 6
amr.n_cell = 8 8 8
geometry.dims = 3
geometry.prob_lo = -4.e-6 -4.e-6 -4.e-6
geometry.prob_hi =  4.e-6  4.e-6  4.e-6
warpx.sort_intervals = 4
particles.species_names = electrons ions
electrons.species_type = electron
electrons.injection_style = NRandomPerCell
electrons.num_particles_per_cell = 8
electrons.profile = constant
electrons.density = 1.e24
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.01
electrons.uy_th = 0.01
electrons.uz_th = 0.01
electrons.do_resampling = 1
electrons.resampling_trigger_intervals = 2::2
ions.species_type = proton
ions.injection_style = NUniformPerCell
ions.num_particles_per_cell_each_dim = 2 2 2
ions.profile = constant
ions.density = 1.e24
ions.momentum_distribution_type = gaussian
ions.ux_th = 0.001
ions.uy_th = 0.001
ions.uz_th = 0.001
ions.do_resampling = 1
ions.resampling_algorithm = velocity_coincidence_thinning
ions.resampling_algorithm_delta_ur = 1e7
ions.resampling_algorithm_n_theta = 2
ions.resampling_algorithm_n_phi = 2
ions.resampling_trigger_intervals = 3::3
"""


def grown(text, old, new):
    """``text`` with ``old`` replaced by ``new``; raises if ``old`` is
    absent (a deck that silently kept its old size would pass as bigger)."""
    if old not in text:
        raise AssertionError(f"{old!r} is not in the deck")
    return text.replace(old, new)


class CpuDraws:
    """A draw source whose numbers come from ``Draws(seed, "cpu")``
    (``warpx_tpu_torch/utils/draws.py``) and are copied to ``device``: two
    runs that ask for the same draws in the same order get the same numbers
    on the card and on the CPU."""

    def __init__(self, seed, device):
        from warpx_tpu_torch.utils.draws import Draws

        self.device = torch.device(device)
        self.cpu = Draws(seed, "cpu")

    def split(self, n):
        return (self,) * n

    def fold_in(self, i):
        return self

    def uniform(self, shape, dtype, lo=0.0, hi=1.0):
        return self.cpu.uniform(shape, dtype, lo, hi).to(self.device)

    def normal(self, shape, dtype):
        return self.cpu.normal(shape, dtype).to(self.device)

    def poisson(self, lam):
        return self.cpu.poisson(lam.cpu()).to(lam.device)

    def exponential(self, shape, dtype):
        return self.cpu.exponential(shape, dtype).to(self.device)


def stochastic_run(text, device, dtype, hook=None, steps=None):
    """The deck through Simulation.from_deck on ``device`` with a
    ``CpuDraws`` source from the configuration's seed; ``hook(sim)`` after
    init."""
    import warpx_tpu_torch
    from warpx_tpu_torch.utils.parser import Deck

    sim = warpx_tpu_torch.Simulation.from_deck(Deck.from_string(text),
                                               dtype=dtype, device=device)
    sim.draws = CpuDraws(sim.cfg.seed, device)
    sim.init()
    if hook is not None:
        hook(sim)
    sim.evolve(-1 if steps is None else steps)
    return sim


def write_fields(arrs):
    """A hook writing the numpy arrays ``arrs`` (by component) into the
    fields after init, in the state's precision and on its device."""
    def hook(sim):
        f = sim.state.fields
        sim.state = sim.state.replace(fields=f.replace(**{
            k: torch.as_tensor(v, dtype=f.Ex.dtype, device=f.Ex.device)
            for k, v in arrs.items()}))
    return hook


def states_agree(got, ref, tol, what):
    """Two runs slot by slot (fields, and every species with its runtime
    attributes: alive masks and integer attributes exactly, the rest within
    ``tol`` of the largest magnitude); returns the worst relative error."""
    worst = 0.0

    def close(a, b, name):
        nonlocal worst
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        scale = float(b.abs().max()) if b.numel() else 0.0
        err = float((a - b).abs().max()) if b.numel() else 0.0
        rel = err / scale if scale else err
        worst = max(worst, rel)
        if not rel <= tol:  # NaN fails too
            raise AssertionError(f"{what}: {name} differs by {rel} of its "
                                 f"largest value (tolerance {tol})")

    for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz"):
        close(getattr(got.state.fields, nm), getattr(ref.state.fields, nm),
              nm)
    for name, sp in ref.state.species.items():
        g = got.state.species[name]
        if not torch.equal(g.alive.cpu(), sp.alive.cpu()):
            raise AssertionError(f"{what}: {name} alive masks differ")
        for k in ("w", "ux", "uy", "uz", "x", "y", "z"):
            if getattr(sp, k) is not None:
                close(getattr(g, k), getattr(sp, k), f"{name}.{k}")
        for k, v in sp.extra.items():
            if v.dtype == torch.int32:
                if not torch.equal(g.extra[k].cpu(), v.cpu()):
                    raise AssertionError(f"{what}: {name}.{k} differs")
            else:
                close(g.extra[k], v, f"{name}.{k}")
    return worst


def stochastic_cases():
    """(name, deck text, hook maker, binned) of stochastic_parity."""
    rng = np.random.default_rng(6)
    n = 16
    ripple = 1 + 0.2 * rng.random((n, n, n))
    # the field held (no Maxwell solver): with Yee, the pairs' current
    # drives the fields past float32's range, and the float32 spread means
    # nothing
    schwinger = grown(grown(grown(grown(
        schwinger_deck(), "warpx.use_filter = 0",
        "warpx.use_filter = 0\nalgo.maxwell_solver = none"),
        "amr.n_cell = 8 8 8", f"amr.n_cell = {n} {n} {n}"),
                            "geometry.prob_lo = -4.e-7 -4.e-7 -4.e-7",
                            "geometry.prob_lo = -8.e-7 -8.e-7 -8.e-7"),
                      "geometry.prob_hi =  4.e-7  4.e-7  4.e-7",
                      "geometry.prob_hi =  8.e-7  8.e-7  8.e-7")
    resample16 = grown(grown(grown(
        RESAMPLE_3D_DECK, "amr.n_cell = 8 8 8", "amr.n_cell = 16 16 16"),
        "geometry.prob_lo = -4.e-6 -4.e-6 -4.e-6",
        "geometry.prob_lo = -8.e-6 -8.e-6 -8.e-6"),
        "geometry.prob_hi =  4.e-6  4.e-6  4.e-6",
        "geometry.prob_hi =  8.e-6  8.e-6  8.e-6")
    return [
        ("ionization_lwfa_32x64", lwfa_nitrogen_deck(LWFA_32X64_DECK), None,
         False),
        ("qed_16x16", qed_deck(ppc=2, steps=3), None, False),
        ("schwinger_16^3", schwinger,
         {"Ez": 2.5e20 * ripple, "By": np.full((n, n, n), 833910140000.0)},
         False),
        ("rr_photons_16x16", RR_PERIODIC_DECK, None, False),
        ("resampling_16^3", resample16 + "tpu.tiled_particles = off\n", None,
         False),
        # 4 steps (both thinnings fire by step 3): the CPU's plain K1 takes
        # ~3 s a step here
        ("resampling_16^3_binned",
         grown(resample16, "max_step = 6", "max_step = 4")
         + "tpu.tiled_particles = on\n",
         None, True),
    ]


def phase_stochastic_parity(dev):
    """Field ionization, QED (quantum synchrotron and Breit-Wheeler with
    photon products, Schwinger), radiation reaction with photons, and both
    thinnings per particle and tile-binned (K1, K3), in float64 on the card
    against the CPU on the same numbers (``CpuDraws``): fields, species and
    their attributes within 1e-12 of their largest values (1e-9 for the
    thinnings, whose group sums and binned J sum in another order),
    checksums within 1e-9;
    then each case in float32 on the card, its checksums' spread against
    float64 reported."""
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling

    out = {}
    for name, text, fields, binned in stochastic_cases():
        hook = write_fields(fields) if fields is not None else None
        k1_0, k3_0 = fp.binned_push_deposit.launches, tiling.ragged_expand.launches
        card = stochastic_run(text, dev, torch.float64, hook)
        k1_n = fp.binned_push_deposit.launches - k1_0
        k3_n = tiling.ragged_expand.launches - k3_0
        cpu = stochastic_run(text, "cpu", torch.float64, hook)
        if card.binned != binned or (binned and not (k1_n and k3_n)):
            raise AssertionError(f"stochastic_parity {name}: binned "
                                 f"{card.binned}, K1 {k1_n}, K3 {k3_n}")
        # the thinnings sum each group's weight, energy and momentum with
        # index_add_, whose order differs between the card's atomics and
        # the CPU, and the merge's perpendicular speed sqrt(v^2 - u^2)
        # cancels: that roundoff reaches ~1e-10, as a binned J's sum order
        # does
        tol = 1e-9 if binned or name.startswith("resampling") else 1e-12
        worst = states_agree(card, cpu, tol, f"stochastic_parity {name}")
        sums64 = card.checksums()
        worst_sum = checksums_agree(sums64, cpu.checksums(), 1e-9,
                                    f"stochastic_parity {name}")
        f32 = stochastic_run(text, dev, torch.float32, hook)
        s32 = f32.checksums()
        spread = {g: max((abs(s32[g][q] - a) / abs(a)
                          for q, a in ref.items()
                          if a and q not in ("divE", "divB")), default=0.0)
                  for g, ref in sums64.items()}
        counts = {nm: int(sp.alive.sum())
                  for nm, sp in card.state.species.items()}
        out[name] = {"tol": tol, "max_rel_err": worst,
                     "checksum_max_rel_err": worst_sum, "alive": counts,
                     "binned": binned, "k1_launches": k1_n,
                     "k3_launches": k3_n, "float32_spread": spread}
    emit("stochastic_parity", ok=True, cases=out)


# ---- independent host evaluations (float64, numpy) -------------------------

ALPHA = 0.007297352573748943
R_E = 2.817940326204929e-15
HBAR = 6.62607015e-34 / (2 * np.pi)
# NIST ionization energies of nitrogen [eV]
N_ENERGIES = (14.53413, 29.60125, 47.4453, 77.4735, 97.8901, 552.06732,
              667.046116)


def adk_host(level, u, e6, dt, energies=N_ENERGIES):
    """The ADK probability per ion in float64 on the host (Chen, JCP 236
    (2013) eq. 2 with WarpX's prefactors; Ionization.H:95-150): ``u`` is
    (3, n) proper velocity [m/s], ``e6`` (6, n) the fields at the ions.
    Returns (p, the JAX package's float32 w dtau of the same inputs)."""
    import math

    energies = np.asarray(energies)
    a3 = ALPHA**3
    wa = a3 * C_LIGHT / R_E
    Ea = M_E * C_LIGHT**2 / Q_E * a3 * ALPHA / R_E
    UH = 13.59843449
    l_eff = math.sqrt(UH / energies[0]) - 1.0
    n_eff = np.arange(1, len(energies) + 1) * np.sqrt(UH / energies)
    C2 = np.array([2.0 ** (2 * n) / (n * math.gamma(n + l_eff + 1.0)
                                     * math.gamma(n - l_eff))
                   for n in n_eff])
    pre = (dt * wa * C2 * (energies / (2.0 * UH))
           * (2.0 * (energies / UH) ** 1.5 * Ea) ** (2.0 * n_eff - 1.0))
    expp = -2.0 / 3.0 * (energies / UH) ** 1.5 * Ea
    pw = -(2.0 * n_eff - 1.0)
    ux, uy, uz = u
    ex, ey, ez, bx, by, bz = e6
    ga = np.sqrt(1.0 + (ux * ux + uy * uy + uz * uz) / C_LIGHT**2)
    udote = (ux * ex + uy * ey + uz * ez) / C_LIGHT
    E = np.sqrt(np.maximum(-udote * udote + (ga * ex + uy * bz - uz * by)**2
                           + (ga * ey + uz * bx - ux * bz)**2
                           + (ga * ez + ux * by - uy * bx)**2, 0.0))
    lev = np.clip(level, 0, len(energies) - 1)
    Es = np.where(E > 0, E, 1.0)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        w = np.where(E > 0, pre[lev] * Es**pw[lev] * np.exp(expp[lev] / Es)
                     / ga, 0.0)
        f = np.float32
        w32 = np.where(E > 0, f(1) / ga.astype(f) * pre[lev].astype(f)
                       * Es.astype(f) ** pw[lev].astype(f)
                       * np.exp(expp[lev].astype(f) / Es.astype(f)), f(0))
    p = np.where(level < len(energies), 1.0 - np.exp(-w), 0.0)
    return p, w32


class timed_fn:
    """Within the block, every call of ``module.name`` records its device
    time with CUDA events."""

    def __init__(self, module, name):
        self.mod, self.name, self.calls = module, name, []

    def __enter__(self):
        fn = self.orig = getattr(self.mod, self.name)

        def run(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            self.calls.append(ev)
            return out
        setattr(self.mod, self.name, run)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)

    def ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.calls]


# 5 steps, for margin under the script's 1200 s limit (each step costs
# ~2 s on the card and ~2.7 s of host ADK evaluation); on an H100 10 steps
# saw 9,664 events against a sum of probabilities of 9,622.8, the first 5
# of them 3,482
# one timed step (2 until the script needed the time for later phases)
LWFA_ION_STEPS = 1


def lwfa_ionization_deck(nx, nz, steps):
    """bench.py's laser-wakefield deck (2 x 2 per cell) with a nitrogen
    dopant at level 5 (1 % of the electron density, x in [-20, 20] um, z in
    [6, 12] um around the antenna at 9 um, 2 x 2 per cell) ionizing into
    ``electrons_n``, per particle (the bounded tile-binned gate refuses an
    ionizable species, as the JAX package's does), the laser's peak 1 fs
    into the run so that the antenna drives 99.6 % of e_max or more over
    the run's 0.5 fs (at the deck's 30 fs it would drive 1.8 %)."""
    text = grown(grown(grown(
        lwfa_deck_text(nx, nz, steps, "f32"),
        "tpu.tiled_particles = on", "tpu.tiled_particles = auto"),
        "particles.species_names = electrons beam",
        "particles.species_names = electrons beam nitrogen electrons_n"),
        "laser1.profile_t_peak = 30.e-15", "laser1.profile_t_peak = 1.e-15")
    return text + """
nitrogen.species_type = nitrogen
nitrogen.injection_style = NUniformPerCell
nitrogen.num_particles_per_cell_each_dim = 2 2
nitrogen.xmin = -20.e-6
nitrogen.xmax = 20.e-6
nitrogen.zmin = 6.e-6
nitrogen.zmax = 12.e-6
nitrogen.profile = constant
nitrogen.density = 2.e21
nitrogen.do_field_ionization = 1
nitrogen.physical_element = N
nitrogen.ionization_initial_level = 5
nitrogen.ionization_product_species = electrons_n
electrons_n.species_type = electron
electrons_n.injection_style = none
"""


def phase_main_lwfa_ionization(dev, smi, nx=2048, nz=8192,
                               steps=LWFA_ION_STEPS):
    """Ionization injection at full width (``lwfa_ionization_deck``),
    float32: init, a warm step, ``steps`` steps each timed with CUDA events
    and preceded by an independent float64 host evaluation of the ADK
    probability (``adk_host``) on the fields the card gathers at the ions,
    then PROFILED_STEPS_PER_PARTICLE profiled steps.  Checks the events of
    each step
    (the rise of the ions' summed level) against sum p within 5 sigma over
    the run, products placed plus dropped equal to the events, finite
    fields and no ion's level past 7.  Reports ms a step, the ionization
    operator's device ms, busy share, peak memory, ions by level, events,
    placed and dropped products, and whether the JAX package's float32 form
    stays finite at this dt."""
    import warpx_tpu_torch
    from warpx_tpu_torch.core import bounded_step
    from warpx_tpu_torch.ops.gather import gather_eb
    from warpx_tpu_torch.utils.parser import Deck

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(lwfa_ionization_deck(
            nx, nz, steps + 1 + PROFILED_STEPS_PER_PARTICLE + 1)),
        dtype=torch.float32, device=dev)
    if not sim.is_bounded or sim.binned:
        raise AssertionError("main_lwfa_ionization did not take the "
                             "per-particle bounded step")
    sim.init()
    n_ions = int(sim.state.species["nitrogen"].alive.sum())
    cap_n = sim.state.species["electrons_n"].capacity
    sim.evolve(1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    st = sim.stepper
    cfg = sim.cfg

    def ion_fields(state):
        ion = state.species["nitrogen"]
        farr = st._padded_eb(state.fields)
        e6 = gather_eb(ion.positions(2), farr, st.staggering, cfg.geometry,
                       cfg.particle_shape, cfg.galerkin,
                       origin=st.gal_origin_at(st.origin_of(state), state),
                       wrap=False, offset=st.ng)
        return ion, e6

    per_step, ms_steps = [], []
    sum_p = var_p = 0.0
    nonfinite_jax = 0
    with timed_fn(bounded_step, "ionization_substep") as op:
        for _ in range(steps):
            ion, e6 = ion_fields(sim.state)
            alive = ion.alive.cpu().numpy()
            lev0 = ion.extra["ionizationLevel"].cpu().numpy()
            u = np.stack([getattr(ion, c).double().cpu().numpy()[alive]
                          for c in ("ux", "uy", "uz")])
            e6h = np.stack([a.double().cpu().numpy()[alive] for a in e6])
            p, w32 = adk_host(lev0[alive], u, e6h, cfg.dt)
            nonfinite_jax += int((~np.isfinite(w32)).sum())
            n_prod0 = int(sim.state.species["electrons_n"].alive.sum())
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            sim.evolve(1)
            b.record()
            b.synchronize()
            ms_steps.append(a.elapsed_time(b))
            ion1 = sim.state.species["nitrogen"]
            events = int(ion1.extra["ionizationLevel"].sum()) - int(
                lev0.sum())
            placed = int(sim.state.species["electrons_n"].alive.sum()) \
                - n_prod0
            per_step.append({"events": events, "sum_p": float(p.sum()),
                             "placed": placed, "dropped": events - placed,
                             "ions_in_field_gt_1e12": int(
                                 (np.abs(e6h[:3]).max(0) > 1e12).sum())})
            sum_p += float(p.sum())
            var_p += float((p * (1 - p)).sum())
        op_ms = op.ms()
    breakdown = profile_steps(sim, PROFILED_STEPS_PER_PARTICLE)
    peak = torch.cuda.max_memory_allocated()
    total = sum(s["events"] for s in per_step)
    sigma = max(var_p, 1.0) ** 0.5
    if not abs(total - sum_p) <= 5 * sigma:
        raise AssertionError(f"main_lwfa_ionization: {total} events against "
                             f"sum p = {sum_p} (sigma {sigma})")
    if total <= 0:
        raise AssertionError("main_lwfa_ionization: no ionization event")
    if any(s["dropped"] < 0 for s in per_step):
        raise AssertionError("main_lwfa_ionization: more products than "
                             "events")
    lev = sim.state.species["nitrogen"].extra["ionizationLevel"]
    alive = sim.state.species["nitrogen"].alive
    by_level = torch.bincount(lev[alive].long(), minlength=8).tolist()
    if len(by_level) > 8 or int(alive.sum()) != n_ions:
        raise AssertionError(f"main_lwfa_ionization: levels {by_level}, "
                             f"{int(alive.sum())} ions of {n_ions}")
    for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz"):
        if not bool(torch.isfinite(getattr(sim.state.fields, nm)).all()):
            raise AssertionError(f"main_lwfa_ionization: {nm} not finite")
    from warpx_tpu_torch.ops.ionization import adk_coefficients

    pre = adk_coefficients("N", cfg.dt)[0]
    emit("main_lwfa_ionization", ok=True, n_cell=cfg.geometry.n_cell,
         dt=cfg.dt, laser_t_peak=1e-15, n_ions=n_ions,
         product_capacity=cap_n,
         n_electrons=int(sim.state.species["electrons"].alive.sum()),
         steps_timed=steps, ms_per_step=sum(ms_steps) / steps,
         ms_each_step=[round(m, 3) for m in ms_steps],
         ionization_ms_per_step=sum(op_ms) / len(op_ms),
         init_s=init_s, device_busy_share=breakdown["device_busy_share"],
         peak_memory_bytes=peak, ions_by_level=by_level,
         events_total=total, sum_p=sum_p, sigma=sigma, per_step=per_step,
         placed_total=sum(s["placed"] for s in per_step),
         dropped_total=sum(s["dropped"] for s in per_step),
         jax_form_float32={"largest_prefactor": float(pre.max()),
                           "float32_max": float(np.finfo(np.float32).max),
                           "nonfinite_rates": nonfinite_jax},
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    emit("main_lwfa_ionization_profile", steps=PROFILED_STEPS_PER_PARTICLE,
         **breakdown)


def boris_host(u, dt, sign, rr):
    """One Boris push of a lepton (charge ``sign`` q_e) in E_F, B_F in
    float64 on the host, with the classical radiation-reaction force at the
    time-centered momentum when ``rr`` (Tamburini et al., NJP 12 123005;
    UpdateMomentumBorisWithRadiationReaction.H)."""
    q = sign * Q_E
    econst = 0.5 * q * dt / M_E
    um = u + econst * E_F
    inv_g = 1 / np.sqrt(1 + um @ um / C_LIGHT**2)
    t = econst * inv_g * B_F
    s = 2 * t / (1 + t @ t)
    up = um + np.cross(um, t)
    un = um + np.cross(up, s) + econst * E_F
    if not rr:
        return un
    uc = 0.5 * (un + u)
    gam = np.sqrt(1 + uc @ uc / C_LIGHT**2)
    v = uc / gam
    bn = v / C_LIGHT
    fl = E_F + np.cross(v, B_F)
    bdote = bn @ E_F
    coeff = gam * gam * (fl @ fl - bdote * bdote)
    qmc = q / (M_E * C_LIGHT)
    rrc = (2.0 / 3.0) * R_E * qmc * qmc
    fr = rrc * (C_LIGHT * np.cross(fl, B_F) + bdote * E_F - coeff * bn)
    return un + fr * dt


def qs_G_host(chi):
    """G(chi) = int_0^1 S(chi, xi)/xi dxi by adaptive quadrature (the
    reference's analysis_quantum_sync.py; tests/test_qed.py)."""
    import scipy.integrate as integ
    import scipy.special as spe

    def inner(y):
        return integ.quad(
            lambda x: np.exp(-y * (1 + 4 * x**2 / 3) * np.sqrt(1 + x * x / 3))
            * (9 + 36 * x**2 + 16 * x**4)
            / (3 + 4 * x**2) / np.sqrt(1 + x**2 / 3), 0, np.inf)[0] \
            / np.sqrt(3)

    def S(xi):
        if xi in (0.0, 1.0):
            return 0.0
        Y = (2 / 3) * xi / (chi * (1 - xi))
        return np.sqrt(3) / 2 / np.pi * xi * (
            inner(Y) + xi**2 * spe.kv(2 / 3, Y) / (1 - xi))

    return integ.quad(lambda xi: S(xi) / xi if xi > 0 else 0.0, 0, 1,
                      limit=200)[0]


def bw_T_host(chi):
    """T(chi) of Breit-Wheeler by adaptive quadrature
    (analysis_breit_wheeler_core.py; tests/test_qed.py)."""
    import scipy.integrate as integ
    import scipy.special as spe

    def bw_inner(x):
        return integ.quad(lambda s: np.sqrt(s) * spe.kv(1 / 3, 2 / 3
                                                        * s**1.5),
                          x, np.inf)[0]

    def F(ce):
        if ce <= 0 or chi <= ce:
            return 0.0
        X = (chi / (ce * (chi - ce))) ** (2 / 3)
        return bw_inner(X) - (2.0 - chi * X**1.5) * spe.kv(
            2 / 3, 2 / 3 * X**1.5)

    return integ.quad(F, 0, chi, limit=200)[0] / (np.pi * np.sqrt(3)
                                                  * chi**2)


def chi_host(u, photon):
    """chi of a lepton (proper velocity ``u``) or a photon (``u`` = p/m_e)
    in E_F, B_F (QedChiFunctions.H)."""
    E_s = M_E**2 * C_LIGHT**3 / (Q_E * HBAR)
    if photon:
        pn = np.linalg.norm(u)
        v = C_LIGHT * u / pn
        scale = pn / C_LIGHT
    else:
        scale = np.sqrt(1.0 + u @ u / C_LIGHT**2)
        v = u / scale
    f = E_F + np.cross(v, B_F)
    vde = v @ E_F / C_LIGHT
    return scale * np.sqrt(f @ f - vde * vde) / E_s


# tests/test_qed.py's momenta (units of m_e c) and the leptons' charges
QS_MOMENTA = ((10.0, 0, 0), (0, 100.0, 0), (0, 0, 1000.0),
              (5773.502691896,) * 3)
QS_SIGNS = (-1, -1, 1, 1)
BW_MOMENTA = ((2000.0, 0, 0), (0, 5000.0, 0), (0, 0, 10000.0),
              (57735.02691896,) * 3)
# the radiation-reaction electrons start at 10 m_e c along z; the external
# E field adds ~7 m_e c a step at the QED box's dt, and the reaction force
# changes the momentum by ~1e-3 of itself a step (at 1000 m_e c the
# explicit force exceeds the momentum within a few steps)
RR_MOMENTUM = (0.0, 0.0, 10.0)
QED_STEPS = 3


def qed_box_deck(n=128, steps=QED_STEPS):
    """uniform-128's grid as a QED box: n^3 cells of 2.5 nm (0.32 um at
    n = 128; dt 4.81e-18 s), periodic, float32 per particle, under the
    reference QED decks' fields.  The cell sets dt: at this dt the QED
    tables' interpolation (0.1-0.6 % off the quadrature rates) stays under
    2 sigma of the yields of 2.1 M parents; at 4x the cell it reaches 3.4
    sigma for the 10 m_e c leptons.  Four leptons at
    tests/test_qed.py's quantum-synchrotron momenta emitting into photon
    species ``qsp1``..``qsp4``, four photon species at its Breit-Wheeler
    momenta converting into ``bwe1``/``bwp1``..``bwe4``/``bwp4``, and
    electrons ``rr`` with classical radiation reaction; one particle per
    cell each at 1e10 m^-3, where the self-fields are ~1e-12 V/m against the
    external 2.4e15."""
    half = n * 1.25e-9
    lines = [f"max_step = {steps}", f"amr.n_cell = {n} {n} {n}",
             "geometry.dims = 3",
             f"geometry.prob_lo = {-half!r} {-half!r} {-half!r}",
             f"geometry.prob_hi = {half!r} {half!r} {half!r}",
             "algo.particle_shape = 1"]
    names = []
    for i, (u, sgn) in enumerate(zip(QS_MOMENTA, QS_SIGNS), 1):
        kind = "electron" if sgn < 0 else "positron"
        names += [f"qs{i}", f"qsp{i}"]
        lines += [f"qs{i}.species_type = {kind}",
                  f"qs{i}.do_qed_quantum_sync = 1",
                  f"qs{i}.qed_quantum_sync_phot_product_species = qsp{i}",
                  f"qsp{i}.species_type = photon",
                  f"qsp{i}.injection_style = none"]
        lines += _uniform_lines(f"qs{i}", u)
    for i, u in enumerate(BW_MOMENTA, 1):
        names += [f"bw{i}", f"bwe{i}", f"bwp{i}"]
        lines += [f"bw{i}.species_type = photon",
                  f"bw{i}.do_qed_breit_wheeler = 1",
                  f"bw{i}.qed_breit_wheeler_ele_product_species = bwe{i}",
                  f"bw{i}.qed_breit_wheeler_pos_product_species = bwp{i}",
                  f"bwe{i}.species_type = electron",
                  f"bwe{i}.injection_style = none",
                  f"bwp{i}.species_type = positron",
                  f"bwp{i}.injection_style = none"]
        lines += _uniform_lines(f"bw{i}", u)
    names.append("rr")
    lines += ["rr.species_type = electron",
              "rr.do_classical_radiation_reaction = 1"]
    lines += _uniform_lines("rr", RR_MOMENTUM)
    lines.insert(0, "particles.species_names = " + " ".join(names))
    return "\n".join(lines) + "\n" + QED_FIELDS


def _uniform_lines(name, u):
    return [f"{name}.injection_style = NUniformPerCell",
            f"{name}.num_particles_per_cell_each_dim = 1 1 1",
            f"{name}.profile = constant", f"{name}.density = 1.e10",
            f"{name}.momentum_distribution_type = constant",
            f"{name}.ux = {u[0]!r}", f"{name}.uy = {u[1]!r}",
            f"{name}.uz = {u[2]!r}"]


def phase_main_qed(dev, smi, n=128, steps=QED_STEPS):
    """The QED box (``qed_box_deck``) at n^3, float32, per particle: init,
    two steps, the yields checked, then the remaining steps with each QED
    pass timed (the first pass, which builds the host tables, is reported
    apart and left out of ``qed_ms_per_step``).  Checks each photon species' count and each pair species'
    count after the second step (the first step's push lowers the optical
    depths, the second step's events emit) within 5 sigma of the analytic
    N0 (1 - exp(-dN/dt dt)) (tests/test_qed.py:121-131, 154-166: chi at the
    Boris-pushed momentum for the leptons, at the initial one for the
    photons); electrons equal to positrons pair species by pair species;
    the radiation-reaction species' momenta against a float64 host
    evaluation of the pusher at 1e-5; finite fields."""
    import warpx_tpu_torch
    from warpx_tpu_torch.ops import qed as qed_mod
    from warpx_tpu_torch.utils.parser import Deck

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(qed_box_deck(n, steps + 2)), dtype=torch.float32,
        device=dev)
    if sim.binned:
        raise AssertionError("main_qed took the tile-binned step")
    sim.init()
    init_s = time.perf_counter() - t0
    dt = sim.cfg.dt
    n0 = n ** 3
    with timed_fn(qed_mod, "qed_update") as op:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        sim.evolve(2)
        b.record()
        b.synchronize()
        ms_first = a.elapsed_time(b) / 2
        sp = sim.state.species
        yields = {}
        for i, (u, sgn) in enumerate(zip(QS_MOMENTA, QS_SIGNS), 1):
            p0 = np.array(u) * C_LIGHT
            pb = boris_host(boris_host(p0, -0.5 * dt, sgn, False), dt, sgn,
                            False)
            gam = np.sqrt(1 + pb @ pb / C_LIGHT**2)
            rate = ((2 / 3) * ALPHA * M_E * C_LIGHT**2 / HBAR
                    * qs_G_host(chi_host(pb, False)) / gam)
            yields[f"qsp{i}"] = (int(sp[f"qsp{i}"].alive.sum()), rate)
        for i, u in enumerate(BW_MOMENTA, 1):
            p0 = np.array(u) * C_LIGHT
            chi = chi_host(p0, True)
            rate = (ALPHA * M_E * C_LIGHT**2 / HBAR * bw_T_host(chi) * chi
                    / (np.linalg.norm(p0) / C_LIGHT))
            ne = int(sp[f"bwe{i}"].alive.sum())
            if ne != int(sp[f"bwp{i}"].alive.sum()):
                raise AssertionError(f"main_qed: bwe{i} and bwp{i} differ")
            yields[f"bwe{i}"] = (ne, rate)
        checks = {}
        for nm, (got, rate) in yields.items():
            exp_n = n0 * (1 - np.exp(-rate * dt))
            sig = max(exp_n * np.exp(-rate * dt), 1.0) ** 0.5
            checks[nm] = {"count": got, "expected": exp_n, "sigma": sig,
                          "z": (got - exp_n) / sig}
            if not abs(got - exp_n) <= 5 * sig:
                raise AssertionError(f"main_qed: {nm} {got} against "
                                     f"{exp_n} (sigma {sig})")
        # the radiation-reaction species against the host pusher
        u = np.array(RR_MOMENTUM) * C_LIGHT
        u = boris_host(u, -0.5 * dt, -1, True)
        for _ in range(2):
            u = boris_host(u, dt, -1, True)
        rr = sp["rr"]
        got = torch.stack([rr.ux[:4096], rr.uy[:4096], rr.uz[:4096]],
                          1).double().cpu().numpy()
        rr_err = float(np.abs(got - u).max() / np.abs(u).max())
        plain = boris_host(boris_host(boris_host(
            np.array(RR_MOMENTUM) * C_LIGHT, -0.5 * dt, -1, False), dt, -1,
            False), dt, -1, False)
        rr_effect = float(np.abs(u - plain).max() / np.abs(u).max())
        if not rr_err <= 1e-5:
            raise AssertionError(f"main_qed: the radiation-reaction species "
                                 f"is {rr_err} off the host pusher")
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(steps - 1)]
        marks[0].record()
        for mark in marks[1:]:
            sim.evolve(1)
            mark.record()
        marks[-1].synchronize()
        ms_steps = [marks[i].elapsed_time(marks[i + 1])
                    for i in range(len(marks) - 1)]
        op_ms = op.ms()
    breakdown = profile_steps(sim, 1)
    for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz"):
        if not bool(torch.isfinite(getattr(sim.state.fields, nm)).all()):
            raise AssertionError(f"main_qed: {nm} not finite")
    emit("main_qed", ok=True, n_cell=sim.cfg.geometry.n_cell, dt=dt,
         n_per_species=n0, n_species=len(sim.cfg.species),
         slots=sum(s.capacity for s in sim.state.species.values()),
         init_s=init_s, ms_per_step_first_two=ms_first,
         ms_per_step=sum(ms_steps) / len(ms_steps),
         ms_each_step=[round(m, 3) for m in ms_steps],
         qed_ms_first_call=op_ms[0],
         qed_ms_per_step=sum(op_ms[1:]) / len(op_ms[1:]),
         qed_ms_each=op_ms,
         yields=checks, rr_max_rel_err=rr_err, rr_tol=1e-5,
         rr_effect_rel=rr_effect,
         device_busy_share=breakdown["device_busy_share"],
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    emit("main_qed_profile", steps=1, **breakdown)


# tests/test_qed.py's Schwinger case 2 (the Gaussian regime)
SCHWINGER_FIELD = (1.0e18, 0.0, 0.0, 1679288857.0516706, 525665014.1557486,
                   1836353079.9561853)
SCHWINGER_STEPS = 4
# the bias the card's float32 Schwinger rate may carry, as a share of the
# expectation: every step read 2.54-2.57e-7 below it on an H100 (PERF.md
# section 6, PR 14)
SCHWINGER_BIAS = 1e-6


def schwinger_box_deck(n=128, steps=SCHWINGER_STEPS, slab=16):
    """A 1 um periodic box at n^3 cells with Schwinger pair creation into
    ``es``/``ps``, its field held (algo.maxwell_solver = none) at the
    uniform value written after init, the activation region a slab of
    ``slab`` cells along z between cell faces (no cell center on its
    edge): (steps + 1) n^2 slab producing cells stay under the product
    budget min(n^3 max_step, 2,000,000)."""
    half = 0.5e-6
    dz = 2 * half / n
    return f"""
max_step = {steps + 1}
amr.n_cell = {n} {n} {n}
geometry.dims = 3
geometry.prob_lo = {-half!r} {-half!r} {-half!r}
geometry.prob_hi = {half!r} {half!r} {half!r}
algo.maxwell_solver = none
warpx.use_filter = 0
warpx.do_qed_schwinger = 1
qed_schwinger.ele_product_species = es
qed_schwinger.pos_product_species = ps
qed_schwinger.zmin = {-slab / 2 * dz!r}
qed_schwinger.zmax = {slab / 2 * dz!r}
particles.species_names = es ps
es.species_type = electron
es.injection_style = none
ps.species_type = positron
ps.injection_style = none
"""


def schwinger_rate_host(fields):
    """Pairs per unit volume and time from the field invariants
    (analysis_schwinger.py:calculate_rate; tests/test_qed.py:188-212)."""
    Ex, Ey, Ez, Bx, By, Bz = fields
    E_s = M_E**2 * C_LIGHT**3 / (Q_E * HBAR)
    E2 = Ex**2 + Ey**2 + Ez**2
    H2 = C_LIGHT**2 * (Bx**2 + By**2 + Bz**2)
    F = (E2 - H2) / 2
    G = C_LIGHT * (Ex * Bx + Ey * By + Ez * Bz)
    eps = np.sqrt(np.sqrt(F**2 + G**2) + F) / E_s
    eta = np.sqrt(np.sqrt(F**2 + G**2) - F) / E_s
    pref = Q_E**2 * E_s**2 / 4 / np.pi**2 / C_LIGHT / HBAR**2
    if eta == 0.0:
        return pref * eps**2 / np.pi * np.exp(-np.pi / eps)
    return (pref * eps * eta / np.tanh(np.pi * eta / eps)
            * np.exp(-np.pi / eps))


def phase_main_schwinger(dev, smi, n=128, steps=SCHWINGER_STEPS):
    """Schwinger pair creation at 128^3 (``schwinger_box_deck``), float32:
    the reference's case-2 field written after init, then ``steps`` + 1
    steps, each timed with CUDA events.  Checks, step by step: the new pair
    weight within 5 sigma of n_slab dV dt rate plus SCHWINGER_BIAS of it
    (Gaussian regime: the variance of a cell's count is its mean; the
    card's float32 rate errs alike in every cell); the Gaussian draws, by
    the spread of the new cells' pair weights, whose variance must equal
    their mean (plus float32's rounding of the weights) within 5 of its own
    standard errors; electron weights equal to positron weights.  Then
    every pair placed while under the budget.  Reports ms a step and the
    Schwinger operator's device ms."""
    import warpx_tpu_torch
    from warpx_tpu_torch.ops import qed as qed_mod
    from warpx_tpu_torch.utils.parser import Deck

    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(schwinger_box_deck(n, steps)), dtype=torch.float32,
        device=dev)
    sim.init()
    write_fields({nm: np.full((n,) * 3, v) for nm, v in
                  zip(("Ex", "Ey", "Ez", "Bx", "By", "Bz"),
                      SCHWINGER_FIELD)})(sim)
    geom = sim.cfg.geometry
    dV = float(np.prod(geom.dx))
    dt = sim.cfg.dt
    zc = geom.prob_lo[2] + (np.arange(n) + 0.5) * geom.dx[2]
    lo, hi = sim.cfg.qed_schwinger_bounds_lo[2], \
        sim.cfg.qed_schwinger_bounds_hi[2]
    n_slab = int(((zc >= lo) & (zc <= hi)).sum()) * n * n
    per_cell = dV * dt * schwinger_rate_host(SCHWINGER_FIELD)
    expected = n_slab * per_cell
    sigma = (n_slab * per_cell) ** 0.5
    budget = sim.state.species["es"].capacity
    rows, ms_steps = [], []
    w_prev = 0.0
    was_alive = sim.state.species["es"].alive.clone()
    with timed_fn(qed_mod, "schwinger_update") as op:
        for k in range(steps + 1):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            sim.evolve(1)
            b.record()
            b.synchronize()
            ms_steps.append(a.elapsed_time(b))
            es, ps = sim.state.species["es"], sim.state.species["ps"]
            we = es.w[es.alive].double()
            wp = ps.w[ps.alive].double()
            if not torch.equal(torch.sort(we).values, torch.sort(wp).values):
                raise AssertionError("main_schwinger: electron and positron "
                                     "weights differ")
            w_new = float(we.sum()) - w_prev
            w_prev = float(we.sum())
            # this step's cells: their spread is the draws' (every cell
            # sees the same field, so the float32 rate's bias cancels out
            # of it); the weights are float32, whose rounding (uniform
            # within an ulp of ~5e5 at ~6e12) adds ulp^2/12 to the variance
            fresh = es.alive & ~was_alive
            was_alive = es.alive.clone()
            w32 = es.w[fresh].cpu().numpy()
            wc = w32.astype(np.float64)
            n_c = wc.size
            mean_c = float(wc.mean())
            var_c = float(((wc - mean_c) ** 2).sum() / (n_c - 1))
            var_exp = mean_c + float(np.mean(
                np.spacing(w32).astype(np.float64) ** 2)) / 12
            var_z = (var_c - var_exp) / (var_exp * (2.0 / (n_c - 1)) ** 0.5)
            rows.append({"step": k + 1, "pairs_weight": w_new,
                         "rel_err": (w_new - expected) / expected,
                         "cells": n_c, "cell_variance": var_c,
                         "cell_variance_expected": var_exp,
                         "cell_variance_z": var_z,
                         "alive": int(es.alive.sum())})
            # every producing cell sees the same field, so the card's
            # float32 rate (exp and the invariants, a few ulps) errs alike
            # in all of them: 5 sigma (8e-10 of the expectation) is below
            # that bias, which the bound adds as SCHWINGER_BIAS of the
            # expectation
            if not abs(w_new - expected) <= (5 * sigma
                                             + SCHWINGER_BIAS * expected):
                raise AssertionError(f"main_schwinger: step {k + 1} made "
                                     f"{w_new} pairs against {expected} "
                                     f"(sigma {sigma})")
            if not abs(var_z) <= 5.0:
                raise AssertionError(f"main_schwinger: step {k + 1}'s cells "
                                     f"vary by {var_c} against {var_exp} "
                                     f"({var_z} standard errors)")
        op_ms = op.ms()
    if rows[-1]["alive"] != n_slab * (steps + 1):
        raise AssertionError(f"main_schwinger: {rows[-1]['alive']} pairs "
                             f"placed of {n_slab * (steps + 1)}")
    emit("main_schwinger", ok=True, n_cell=geom.n_cell, dt=dt,
         field=SCHWINGER_FIELD, producing_cells_per_step=n_slab,
         product_budget=budget, expected_per_step=expected, sigma=sigma,
         bias_bound=SCHWINGER_BIAS,
         per_step=rows, ms_per_step=sum(ms_steps[1:]) / steps,
         ms_each_step=[round(m, 3) for m in ms_steps],
         schwinger_ms_each=op_ms,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)


RESAMPLING_STEPS = 25
# the ions' velocity-coincidence bins: one bin of |u| (delta_ur 1 c, past
# any thermal ion at 0.01 c), 2 in azimuth x 2 in polar angle, so that a
# cell's 8 ions spread over 4 direction bins and a bin of 3 or more merges
VCT_BINS = dict(delta_ur=1.0, n_theta=2, n_phi=2)


def resampling_cfg(n=128, steps=RESAMPLING_STEPS):
    """uniform-128 (main_cfg, tile-binned through K1 and K3) with leveling
    thinning on the electrons every 5 steps (target ratio 1.5) and
    velocity-coincidence thinning on the ions every 10 (``VCT_BINS``).  The
    ions have 2 x 2 x 2 per cell instead of main_cfg's 2 x 1 x 1: a group
    merges only with more than two particles in one cell and bin, which two
    per cell never reach."""
    cfg = main_cfg(n, steps)
    el, ions = cfg.species
    el = dataclasses.replace(el, do_resampling=True,
                             resampling_trigger_intervals=("5::5",),
                             resampling_target_ratio=1.5)
    ions = dataclasses.replace(
        ions, num_particles_per_cell_each_dim=(2, 2, 2), do_resampling=True,
        resampling_algorithm="velocity_coincidence_thinning",
        resampling_trigger_intervals=("10::10",),
        resampling_delta_ur=VCT_BINS["delta_ur"] * C_LIGHT,
        resampling_n_theta=VCT_BINS["n_theta"],
        resampling_n_phi=VCT_BINS["n_phi"])
    return dataclasses.replace(cfg, species=(el, ions))


def _cells(sp, geom):
    idx = torch.zeros(sp.capacity, dtype=torch.int64, device=sp.w.device)
    for d, p in enumerate(sp.positions(geom.ndim)):
        i = torch.clamp(torch.floor((p - geom.prob_lo[d]) / geom.dx[d])
                        .long(), 0, geom.n_cell[d] - 1)
        idx = idx * geom.n_cell[d] + i
    return idx


def leveling_expectation(sp, geom, ratio):
    """(expected survivors, their variance, the variance of the surviving
    weight) of one leveling pass on ``sp``, from its cells' level weights,
    in float64."""
    n = int(np.prod(geom.n_cell))
    cell = _cells(sp, geom)
    w = torch.where(sp.alive, sp.w, torch.zeros_like(sp.w)).double()
    a = sp.alive.double()
    wsum = torch.zeros(n, dtype=torch.float64, device=w.device) \
        .index_add_(0, cell, w)
    cnt = torch.zeros(n, dtype=torch.float64, device=w.device) \
        .index_add_(0, cell, a)
    level = ratio * (wsum / cnt.clamp(min=1.0))[cell]
    below = sp.alive & (w < level)
    p = torch.where(below, w / level, a)
    return (float(p.sum()), float((p * (1 - p)).sum()),
            float(torch.where(below, w * (level - w),
                              torch.zeros_like(w)).sum()))


def cell_sums(sp, geom):
    """Per cell: the weight and the three weighted momenta (float64)."""
    n = int(np.prod(geom.n_cell))
    cell = _cells(sp, geom)
    w = torch.where(sp.alive, sp.w, torch.zeros_like(sp.w)).double()
    out = [torch.zeros(n, dtype=torch.float64, device=w.device)
           .index_add_(0, cell, v)
           for v in (w, w * sp.ux.double(), w * sp.uy.double(),
                     w * sp.uz.double())]
    return out


def k1_launch_ms(sim):
    """K1's device ms on the state ``sim`` holds (one launch per pusher
    group, the step's inputs); these launches are not the main path's, so
    the launch counter is put back."""
    from warpx_tpu_torch.core.binned_step import pusher_groups
    from warpx_tpu_torch.ops import fused_pic as fp

    cfg, spec, state = sim.cfg, sim.tile_spec, sim.state
    f = state.fields
    fields6 = fp.pad_fields((f.Ex, f.Ey, f.Ez, f.Bx, f.By, f.Bz), spec)
    groups = list(pusher_groups(state, spec, sim.params))
    kw = dict(spec=spec, geom=cfg.geometry, order=cfg.particle_shape,
              galerkin=cfg.galerkin, dt=cfg.dt,
              stag_items=stag_items(spec.ndim), mxu=cfg.tile_mxu)

    def run():
        for pname, _, params, parts, counts in groups:
            fp.binned_push_deposit(params, fields6, parts, counts=counts,
                                   pusher_name=pname, **kw)
    n0 = fp.binned_push_deposit.launches
    ms = cuda_ms(run, 5)
    fp.binned_push_deposit.launches = n0
    return ms


def phase_main_resampling(dev, smi, k1_row, k3_row, n=128,
                          steps=RESAMPLING_STEPS):
    """uniform-128 with both resampling triggers (``resampling_cfg``),
    tile-binned through K1 and K3, float32, ``steps`` steps with the launch
    counters zeroed before and read after.  Around every pass: the leveling
    pass keeps a count within 5 sigma of the expectation from the cells'
    level weights, and the electrons' total weight stays within 5 sigma of
    its initial value (its expectation is conserved); the velocity
    coincidence conserves the ions' weight and momentum to float32
    roundoff in total and cell by cell; zero tile overflow and violations
    at the end.  Reports ms a step (over all steps, the passes' checks and
    K1 timings included, and the median of the steps without a pass), each
    pass's device ms alone, K1's ms on the state before and after each pass
    (the thinned slots are dead but stay in their tiles until the next
    rebin) and each pass's counts.  Adds this path's K1 and K3
    launches to their rows."""
    import warpx_tpu_torch
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling

    cfg = resampling_cfg(n, steps)
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    if not sim.binned:
        raise AssertionError("main_resampling did not take the tile-binned "
                             "step")
    geom = cfg.geometry
    sim.init()
    el0 = sim.state.species["electrons"]
    w0 = float(el0.w[el0.alive].double().sum())
    var_w = [0.0]
    counters = {"fused_pic": (fp.binned_push_deposit, "launches"),
                "ragged_expand": (tiling.ragged_expand, "launches")}
    for obj, attr in counters.values():
        _counter(obj, attr, 0)
    passes, ms_steps = [], []
    orig = sim.resample

    def resample(timestep):
        fires = {nm: sim._resampling_triggers[nm].contains(timestep)
                 for nm in ("electrons", "ions")}
        if not any(fires.values()):
            return orig(timestep)
        before = sim.state.species
        rec = {"step": timestep, "k1_ms_before": k1_launch_ms(sim)}
        if fires["electrons"]:
            exp_n, var_n, var_pass = leveling_expectation(
                before["electrons"], geom, 1.5)
        if fires["ions"]:
            cs0 = cell_sums(before["ions"], geom)
            n_i0 = int(before["ions"].alive.sum())
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        orig(timestep)
        b.record()
        b.synchronize()
        rec["pass_ms"] = a.elapsed_time(b)
        after = sim.state.species
        if fires["electrons"]:
            el = after["electrons"]
            n_after = int(el.alive.sum())
            var_w[0] += var_pass
            w_now = float(el.w[el.alive].double().sum())
            rec["electrons"] = {
                "before": int(before["electrons"].alive.sum()),
                "after": n_after, "expected": exp_n,
                "sigma": var_n ** 0.5, "weight": w_now,
                "weight_sigma": var_w[0] ** 0.5}
            if not abs(n_after - exp_n) <= 5 * var_n ** 0.5:
                raise AssertionError(f"main_resampling: {n_after} electrons "
                                     f"kept against {exp_n}")
            if not abs(w_now - w0) <= 5 * var_w[0] ** 0.5 + 1e-5 * w0:
                raise AssertionError(f"main_resampling: electron weight "
                                     f"{w_now} against {w0}")
        if fires["ions"]:
            cs1 = cell_sums(after["ions"], geom)
            n_i1 = int(after["ions"].alive.sum())
            scale = cell_sums(dataclasses.replace(
                before["ions"], ux=before["ions"].ux.abs(),
                uy=before["ions"].uy.abs(), uz=before["ions"].uz.abs()),
                geom)
            cell_err = max(float(((a - b).abs() / s.clamp(min=1e-300))
                                 .max()) for a, b, s in zip(cs1, cs0, scale))
            tot_err = max(abs(float(a.sum() - b.sum())) / float(s.sum())
                          for a, b, s in zip(cs1, cs0, scale))
            rec["ions"] = {"before": n_i0, "after": n_i1,
                           "merged_share": 1 - n_i1 / n_i0,
                           "cell_max_rel_err": cell_err,
                           "total_rel_err": tot_err}
            finite = all(bool(torch.isfinite(getattr(after["ions"], k))
                              .all()) for k in ("ux", "uy", "uz", "x", "y",
                                                "z"))
            if not (cell_err <= 1e-5 and n_i1 < n_i0 and finite):
                raise AssertionError(f"main_resampling: velocity coincidence "
                                     f"{rec['ions']}")
        rec["k1_ms_after"] = k1_launch_ms(sim)
        passes.append(rec)

    sim.resample = resample
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        sim.evolve(1)
        b.record()
        b.synchronize()
        ms_steps.append(a.elapsed_time(b))
    sim.resample = orig
    launches = {nm: _counter(obj, attr)
                for nm, (obj, attr) in counters.items()}
    if not all(launches.values()):
        raise AssertionError(f"main_resampling: a kernel never ran: "
                             f"{launches}")
    if len(passes) != steps // 5:
        raise AssertionError(f"main_resampling: {len(passes)} passes")
    sums = sim.checksums()  # raises on tile overflow or violations
    for group in sums.values():
        for q, v in group.items():
            if not np.isfinite(v):
                raise AssertionError(f"main_resampling: non-finite {q}")
    add_launches({"fused_pic": k1_row, "ragged_expand": k3_row}, launches,
                 "main_resampling")
    quiet = [m for k, m in enumerate(ms_steps[1:], 2) if k % 5]
    emit("main_resampling", ok=True, n_cell=geom.n_cell,
         slots={nm: s.capacity for nm, s in sim.state.species.items()},
         vct_bins=VCT_BINS, steps=steps,
         ms_per_step=sum(ms_steps) / steps,
         ms_per_quiet_step=float(np.median(quiet)),
         ms_each_step=[round(m, 3) for m in ms_steps], passes=passes,
         electron_weight={"initial": w0,
                          "final": sums["electrons"]["particle_weight"],
                          "sigma": var_w[0] ** 0.5},
         alive_end={nm: int(s.alive.sum())
                    for nm, s in sim.state.species.items()},
         launches=launches, tile_overflow=0, tile_violations=0,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)


# ---- binary collisions ------------------------------------------------------


class CastDraws(CpuDraws):
    """``CpuDraws`` whose numbers are drawn in float64 and rounded to the
    dtype asked for: a float32 and a float64 run on the same numbers."""

    def uniform(self, shape, dtype, lo=0.0, hi=1.0):
        return self.cpu.uniform(shape, torch.float64, lo, hi).to(
            device=self.device, dtype=dtype)

    def normal(self, shape, dtype):
        return self.cpu.normal(shape, torch.float64).to(device=self.device,
                                                        dtype=dtype)


def inv_v_table(sigma0, e_ref, e_lo=0.2, e_hi=5000.0, de=0.2,
                zero_first=False):
    """(energies [eV], sigmas [m^2]) with sigma = sigma0 sqrt(e_ref / E) on
    a uniform grid (tests/test_mcc.py::_inv_v_xsec): nu = n sigma v is
    constant, so the null-collision probability is exact; ``zero_first``
    makes it 0 at and below the first energy (an ionization threshold)."""
    es = np.arange(e_lo, e_hi + de / 2, de)
    sg = sigma0 * np.sqrt(e_ref / es)
    if zero_first:
        sg[0] = 0.0
    return es, sg


def write_collision_tables(d):
    """The cross-section files the collision decks name, in ``d``: MCC
    elastic, excitation (19.8 eV) and ionization (24.6 eV) tables of
    ``inv_v_table``, and three two-segment DSMC tables."""
    for name, e_lo, zero in (("el", 0.2, False), ("ex", 19.8, False),
                             ("iz", 24.6, True)):
        es, sg = inv_v_table(2e-20, 100.0, e_lo=e_lo, zero_first=zero)
        np.savetxt(pathlib.Path(d) / f"{name}.dat", np.column_stack([es, sg]))
    for name, s in (("d_el", 4e-19), ("d_back", 2e-19), ("d_cx", 3e-19)):
        np.savetxt(pathlib.Path(d) / f"{name}.dat",
                   np.array([[0.0, s], [1.0, s], [1e4, 0.5 * s]]))


def collide16_deck(steps=3, n=16):
    """An n^3 box (no field solve) with every pairwise kind: intra e-e and
    inter e-p Coulomb, D-T fusion into alpha and neutron, intra-species
    D-D into he3 and neutron, p-B11 into alphas."""
    sp = ""
    for nm, st, ppc, dens, th, frozen in (
            ("electrons", "electron", 4, 1e24, 0.01, False),
            ("protons", "proton", 2, 1e24, 0.0005, False),
            ("deut", "hydrogen2", 4, 1e26, 0.0023, True),
            ("trit", "hydrogen3", 2, 1e26, 0.0019, True),
            ("prot", "hydrogen1", 2, 1e26, 0.02, True),
            ("boron", "boron11", 2, 1e26, 0.001, True)):
        sp += f"""
{nm}.species_type = {st}
{nm}.injection_style = NRandomPerCell
{nm}.num_particles_per_cell = {ppc}
{nm}.profile = constant
{nm}.density = {dens}
{nm}.momentum_distribution_type = gaussian
{nm}.ux_th = {th}
{nm}.uy_th = {th}
{nm}.uz_th = {th}
"""
        if frozen:
            sp += f"{nm}.do_not_push = 1\n{nm}.do_not_deposit = 1\n"
    for nm, st in (("alpha", "helium4"), ("neutron", "neutron"),
                   ("he3", "helium3"), ("alpha_pb", "helium4")):
        sp += f"""
{nm}.species_type = {st}
{nm}.injection_style = none
{nm}.do_not_push = 1
{nm}.do_not_deposit = 1
"""
    return f"""
max_step = {steps}
amr.n_cell = {n} {n} {n}
geometry.dims = 3
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = {n * 1e-6} {n * 1e-6} {n * 1e-6}
warpx.const_dt = 1.e-12
algo.maxwell_solver = none
warpx.use_filter = 0
particles.species_names = electrons protons deut trit prot boron alpha neutron he3 alpha_pb
collisions.collision_names = c_ee c_ep dt dd pb
c_ee.species = electrons electrons
c_ep.species = electrons protons
dt.type = nuclearfusion
dt.species = deut trit
dt.product_species = alpha neutron
dt.fusion_multiplier = 1.e7
dd.type = nuclearfusion
dd.species = deut deut
dd.product_species = he3 neutron
dd.fusion_multiplier = 1.e9
pb.type = nuclearfusion
pb.species = prot boron
pb.product_species = alpha_pb
pb.fusion_multiplier = 1.e10
""" + sp


def mcc32_deck(steps=4):
    """32 x 32 periodic, no field solve: electrons with MCC elastic,
    excitation and ionization on helium (products into 'hep'), 'hep' ions
    and 'he' neutrals with DSMC elastic, back and charge exchange, stopping
    of the electrons on an electron background and of 'hep' on an ion
    background (a copy of tests/test_torch_dsmc_mcc.py::periodic_deck)."""
    return f"""
max_step = {steps}
amr.n_cell = 32 32
geometry.dims = 2
geometry.prob_lo = 0. 0.
geometry.prob_hi = 3.2e-5 3.2e-5
warpx.const_dt = 2.e-12
algo.maxwell_solver = none
warpx.use_filter = 0
particles.species_names = electrons hep he
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 2 2
electrons.profile = constant
electrons.density = 1.e18
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.03
electrons.uy_th = 0.03
electrons.uz_th = 0.03
electrons.do_not_deposit = 1
hep.species_type = helium
hep.charge = q_e
hep.injection_style = NUniformPerCell
hep.num_particles_per_cell_each_dim = 2 2
hep.profile = constant
hep.density = 1.e18
hep.momentum_distribution_type = gaussian
hep.ux_th = 0.0003
hep.uy_th = 0.0003
hep.uz_th = 0.0003
hep.uz_m = 0.0002
hep.do_not_deposit = 1
he.species_type = helium
he.charge = 0.
he.injection_style = NUniformPerCell
he.num_particles_per_cell_each_dim = 1 2
he.profile = constant
he.density = 1.e22
he.momentum_distribution_type = gaussian
he.ux_th = 0.00001
he.uy_th = 0.00001
he.uz_th = 0.00001
he.do_not_deposit = 1
collisions.collision_names = dsmc1 mcc1 stop_e stop_i
dsmc1.type = dsmc
dsmc1.species = hep he
dsmc1.scattering_processes = elastic back charge_exchange
dsmc1.elastic_cross_section = d_el.dat
dsmc1.back_cross_section = d_back.dat
dsmc1.charge_exchange_cross_section = d_cx.dat
mcc1.type = background_mcc
mcc1.species = electrons
mcc1.background_density = 1.e22
mcc1.background_temperature = 300.
mcc1.ionization_species = hep
mcc1.scattering_processes = elastic excitation1 ionization
mcc1.elastic_cross_section = el.dat
mcc1.excitation1_cross_section = ex.dat
mcc1.excitation1_energy = 19.8
mcc1.ionization_cross_section = iz.dat
mcc1.ionization_energy = 24.6
stop_e.type = background_stopping
stop_e.species = electrons
stop_e.background_type = electrons
stop_e.background_density = 1.e22
stop_e.background_temperature = 5.e4
stop_i.type = background_stopping
stop_i.species = hep
stop_i.background_type = ions
stop_i.background_mass = 6.6464731e-27
stop_i.background_charge_state = 1.
stop_i.background_density(x,y,z,t) = 1.e24*(1+x/3.2e-5)
stop_i.background_temperature = 1.e4
"""


def lwfa_mcc_deck(steps=8):
    """The 32 x 64 laser-wakefield deck with its electrons on a helium
    background (MCC elastic and ionization into 'hep') and stopping of the
    electrons and of 'hep' (a copy of
    tests/test_torch_dsmc_mcc.py::lwfa_mcc_deck)."""
    return LWFA_32X64_DECK.replace(
        "max_step = 12", f"max_step = {steps}").replace(
        "particles.species_names = electrons beam",
        "particles.species_names = electrons beam hep") + """
hep.species_type = helium
hep.charge = q_e
hep.injection_style = none
collisions.collision_names = mcc1 stop_e stop_i
mcc1.type = background_mcc
mcc1.species = electrons
mcc1.background_density = 1.e25
mcc1.background_temperature = 300.
mcc1.ionization_species = hep
mcc1.scattering_processes = elastic ionization
mcc1.elastic_cross_section = el.dat
mcc1.ionization_cross_section = iz.dat
mcc1.ionization_energy = 24.6
stop_e.type = background_stopping
stop_e.species = electrons
stop_e.background_density = 1.e24
stop_e.background_temperature = 5.e4
stop_i.type = background_stopping
stop_i.species = hep
stop_i.background_type = ions
stop_i.background_mass = 6.6464731e-27
stop_i.background_charge_state = 1.
stop_i.background_density = 1.e24
stop_i.background_temperature = 1.e4
"""


def deck_sim(text, tables, device, dtype):
    """The deck written beside the collision tables (``tables``) and built
    through Simulation.from_deck from that file, so that its relative table
    paths resolve against the deck's directory."""
    import warpx_tpu_torch
    from warpx_tpu_torch.utils.parser import Deck

    path = pathlib.Path(tables) / "inputs"
    path.write_text(text)
    return warpx_tpu_torch.Simulation.from_deck(Deck.from_file(str(path)),
                                                dtype=dtype, device=device)


def collision_run(text, tables, device, dtype, steps=None):
    """The deck through Simulation.from_deck on ``device`` on the numbers
    of one CPU generator (``CpuDraws``); ``steps`` steps."""
    sim = deck_sim(text, tables, device, dtype)
    sim.draws = CpuDraws(sim.cfg.seed, device)
    sim.init()
    sim.evolve(-1 if steps is None else steps)
    return sim


def species_agree(got, ref, tol, what):
    """Two states' species slot by slot (alive masks exactly, the rest
    within ``tol`` of the largest magnitude); the worst relative error."""
    worst = 0.0
    for name, sp in ref.species.items():
        g = got.species[name]
        if not torch.equal(g.alive.cpu(), sp.alive.cpu()):
            raise AssertionError(f"{what}: {name} alive masks differ")
        for k in ("w", "ux", "uy", "uz", "x", "y", "z"):
            a = getattr(sp, k)
            if a is None or not a.numel():
                continue
            b = getattr(g, k).detach().double().cpu()
            a = a.detach().double().cpu()
            scale = float(a.abs().max())
            rel = float((b - a).abs().max()) / scale if scale else 0.0
            worst = max(worst, rel)
            if not rel <= tol:
                raise AssertionError(f"{what}: {name}.{k} differs by {rel} "
                                     f"(tolerance {tol})")
    return worst


def phase_collision_parity(dev):
    """Every collision kind in float64, card against CPU on the numbers of
    one CPU generator: each collision of the 16^3 and 32^2 decks alone on
    their initial states (species within 1e-12 of their largest values),
    the (cell, random) order of the 16^3 electrons identical; then three
    steps of each deck (16^3 pairwise kinds, 32^2 DSMC, MCC and stopping,
    the bounded 32 x 64 laser-wakefield deck with MCC and stopping):
    species and fields within 1e-9, checksums within 1e-9; then each deck
    in float32 on the card, its checksums' spread against float64."""
    from warpx_tpu_torch.core.state import state_from_numpy, state_to_numpy
    from warpx_tpu_torch.core.step import collisions_substep
    from warpx_tpu_torch.ops.collisions import cell_of, sort_by_cell

    tables = tempfile.mkdtemp()
    try:
        write_collision_tables(tables)
        decks = {"pairwise_16^3": collide16_deck(),
                 "dsmc_mcc_stopping_32^2": mcc32_deck(steps=3),
                 "lwfa_mcc_stopping_32x64": lwfa_mcc_deck(steps=3)}
        ops = {}
        for name in ("pairwise_16^3", "dsmc_mcc_stopping_32^2"):
            sim = deck_sim(decks[name], tables, "cpu", torch.float64)
            state0 = sim.init()
            cfg = sim.cfg
            for col in cfg.collisions:
                one = dataclasses.replace(cfg, collisions=(col,))
                ref = collisions_substep(state0, one, CpuDraws(cfg.seed,
                                                               "cpu"))
                card_state = state_from_numpy(state_to_numpy(state0),
                                              torch.float64, dev)
                got = collisions_substep(card_state, one,
                                         CpuDraws(cfg.seed, dev))
                ops[col.name] = species_agree(got, ref, 1e-12,
                                              f"collision_parity {col.name}")
            if name == "pairwise_16^3":
                el = state0.species["electrons"]
                nct = math.prod(cfg.geometry.n_cell)
                r = torch.rand(el.capacity, dtype=torch.float64,
                               generator=torch.Generator().manual_seed(3))
                o_cpu = sort_by_cell(cell_of(el, cfg.geometry, nct), r)
                card_el = state_from_numpy(state_to_numpy(state0),
                                           torch.float64, dev).species[
                    "electrons"]
                o_card = sort_by_cell(cell_of(card_el, cfg.geometry, nct),
                                      r.to(dev))
                if not torch.equal(o_card.cpu(), o_cpu):
                    raise AssertionError("collision_parity: the card's "
                                         "(cell, random) order differs")
        runs = {}
        for name, text in decks.items():
            card = collision_run(text, tables, dev, torch.float64)
            cpu = collision_run(text, tables, "cpu", torch.float64)
            worst = states_agree(card, cpu, 1e-9,
                                 f"collision_parity {name}")
            s64 = card.checksums()
            worst_sum = checksums_agree(s64, cpu.checksums(), 1e-9,
                                        f"collision_parity {name}")
            s32 = collision_run(text, tables, dev, torch.float32).checksums()
            spread = {g: max((abs(s32[g][q] - a) / abs(a)
                              for q, a in ref.items()
                              if a and q not in ("divE", "divB")),
                             default=0.0)
                      for g, ref in s64.items()}
            runs[name] = {"steps": card.state.step, "bounded":
                          card.is_bounded, "max_rel_err": worst,
                          "checksum_max_rel_err": worst_sum,
                          "alive": {nm: int(sp.alive.sum()) for nm, sp in
                                    card.state.species.items()},
                          "float32_spread": spread}
    finally:
        shutil.rmtree(tables, ignore_errors=True)
    emit("collision_parity", ok=True, operators_max_rel_err=ops,
         operator_tol=1e-12, run_tol=1e-9, runs=runs)


# uniform-128-coulomb's plasma: density [m^-3], thermal spreads and the
# electrons' drift (u / c)
COULOMB_N = 1e24
COULOMB_TH_E = 0.0044
COULOMB_TH_P = 0.000033
COULOMB_DRIFT = 0.001


def coulomb_deck(n=128, steps=10):
    """uniform-128-coulomb: electrons (10 eV) drifting at 1e-3 c through
    protons (1 eV), 1e24 m^-3 each, 2 x 2 x 2 per cell, 10.4 um cells
    (dt 2.0e-14 s), Yee, per particle, intra e-e and i-i and inter e-i
    Coulomb every step (the physics of WarpX's Examples/Tests/collision
    e-i relaxation deck).  Neither species deposits: the drift's current
    would drive a plasma oscillation (omega_p dt 1.1) that swings the
    drift faster than the collisions relax it, so the fields stay zero and
    the drift's fall is the collisions' (``coulomb_drift_ratio``: nu_ei dt
    ~ 0.0075)."""
    lo = -n * 5.2e-6
    sp = ""
    for nm, st, th, drift in (("electrons", "electron", COULOMB_TH_E,
                               COULOMB_DRIFT),
                              ("protons", "proton", COULOMB_TH_P, 0.0)):
        sp += f"""
{nm}.species_type = {st}
{nm}.injection_style = NUniformPerCell
{nm}.num_particles_per_cell_each_dim = 2 2 2
{nm}.profile = constant
{nm}.density = {COULOMB_N:.0e}
{nm}.momentum_distribution_type = gaussian
{nm}.ux_th = {th}
{nm}.uy_th = {th}
{nm}.uz_th = {th}
{nm}.uz_m = {drift}
{nm}.do_not_deposit = 1
"""
    return f"""
max_step = {steps}
amr.n_cell = {n} {n} {n}
geometry.dims = 3
geometry.prob_lo = {lo} {lo} {lo}
geometry.prob_hi = {-lo} {-lo} {-lo}
algo.maxwell_solver = yee
algo.current_deposition = esirkepov
algo.particle_shape = 1
warpx.use_filter = 0
particles.species_names = electrons protons
collisions.collision_names = c_ee c_ii c_ei
c_ee.species = electrons electrons
c_ii.species = protons protons
c_ei.species = electrons protons
""" + sp


def momentum_energy(state, cfg, names):
    """(Sum w m u per axis, Sum w m |u| per axis, Sum w m c^2 (gamma - 1))
    over the alive slots of the species ``names``, in float64 on the
    device."""
    p = torch.zeros(3, dtype=torch.float64, device=state.fields.Ex.device)
    pa = torch.zeros_like(p)
    e = torch.zeros((), dtype=torch.float64, device=p.device)
    for s in cfg.species:
        if s.name not in names:
            continue
        sp = state.species[s.name]
        w = torch.where(sp.alive, sp.w, 0.0).double()
        u = torch.stack([sp.ux, sp.uy, sp.uz]).double()
        p += s.mass * (w * u).sum(1)
        pa += s.mass * (w * u.abs()).sum(1)
        u2 = (u * u).sum(0) / C_LIGHT ** 2
        e += s.mass * C_LIGHT ** 2 * (w * u2 / (1 + torch.sqrt(1 + u2))).sum()
    return p.cpu().numpy(), pa.cpu().numpy(), float(e)


def drift_difference(state):
    """<uz_e> - <uz_p> over the alive slots, in units of c."""
    out = []
    for nm in ("electrons", "protons"):
        sp = state.species[nm]
        out.append(float(sp.uz[sp.alive].double().mean()) / C_LIGHT)
    return out[0] - out[1]


def coulomb_drift_ratio(dt, steps):
    """The drift difference's expected ratio after ``steps`` e-i
    collisions of ``dt``: exp(-nu (1 + m_e / m_p) steps dt) with the
    Braginskii / NRL rate of a slowly drifting Maxwellian on cold ions,
    nu = 4 sqrt(2 pi) n e^4 lnL / (3 (4 pi ep0)^2 sqrt(m_e) T_e^1.5), and
    lnL the port's own Coulomb logarithm (``ops/collisions.py``: bmax the
    two species' Debye length or the atomic spacing, bmin the larger of
    hbar / 2p and b0 / 2, at least 2, sigma capped at 1 / (n rmin))
    averaged with the Lorentz gas's weight 2x exp(-x^2), x = v / (sqrt 2
    v_th).  It leaves out the drift's own size (u / v_th 0.23) and the
    8-particle cells' temperature estimate."""
    ep0, n = 8.8541878128e-12, COULOMB_N
    Te = M_E * (COULOMB_TH_E * C_LIGHT) ** 2
    Tp = M_P * (COULOMB_TH_P * C_LIGHT) ** 2
    lmd = (n * Q_E ** 2 / ep0 * (1 / Te + 1 / Tp)) ** -0.5
    rmin = (4 * math.pi / 3 * n) ** (-1 / 3)
    mu = M_E * M_P / (M_E + M_P)
    x = np.linspace(1e-6, 6.0, 200001)
    v = math.sqrt(2) * COULOMB_TH_E * C_LIGHT * x
    b0 = Q_E ** 2 / (2 * math.pi * ep0 * mu * v ** 2)
    bmin = np.maximum(HBAR / (2 * mu * v), 0.5 * b0)
    lnL = np.maximum(0.5 * np.log1p((max(lmd, rmin) / bmin) ** 2), 2.0)
    lnL = np.minimum(lnL, 1 / (n * rmin) / (math.pi * b0 ** 2))
    w = 2 * x * np.exp(-x * x)
    lnL_eff = float(np.sum(0.5 * (w[1:] * lnL[1:] + w[:-1] * lnL[:-1])
                           * np.diff(x)))
    nu = (4 * math.sqrt(2 * math.pi) * n * Q_E ** 4 * lnL_eff
          / (3 * (4 * math.pi * ep0) ** 2 * math.sqrt(M_E) * Te ** 1.5))
    return math.exp(-nu * (1 + M_E / M_P) * steps * dt), lnL_eff


# each collision alone, equal weights, float32, against the colliding
# species' Sum w m |u| and kinetic energy (H100 readings: see PERF.md)
TOL_COLLIDE_MOMENTUM = 1e-8
TOL_COLLIDE_ENERGY = 1e-6
# the drift's fall, 1 - ratio, within this share of coulomb_drift_ratio's
COULOMB_FALL_BAND = 0.25


def phase_main_coulomb(dev, smi, n=128, steps=10, n_share=32):
    """uniform-128-coulomb (``coulomb_deck``), float32, per particle:
    each collision alone on the initial state conserves Sum w m u (per
    axis, against the colliding species' Sum w m |u|) to
    TOL_COLLIDE_MOMENTUM and their kinetic energy to TOL_COLLIDE_ENERGY
    (equal weights: float32 roundoff of the scaled update); ``steps``
    steps timed with each collision's device ms; the drift difference's
    fall lies within COULOMB_FALL_BAND of ``coulomb_drift_ratio``'s; then
    at ``n_share``^3 the share
    of the electrons' momenta that one intra collision changes in float32
    is at least 0.9 of float64's on the same draws (the JAX package's
    float32 form changes none)."""
    import warpx_tpu_torch
    from warpx_tpu_torch.core.step import collisions_substep
    from warpx_tpu_torch.ops import collisions as col_mod
    from warpx_tpu_torch.utils.parser import Deck

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # one step past ``steps`` for the profiled step (and no closing
    # half-push inside the timed ones)
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(coulomb_deck(n, steps + 1)), dtype=torch.float32,
        device=dev)
    if sim.binned:
        raise AssertionError("main_coulomb took the tile-binned step")
    sim.init()
    init_s = time.perf_counter() - t0
    cfg = sim.cfg
    state0 = sim.state
    conserve = {}
    for col in cfg.collisions:
        one = dataclasses.replace(cfg, collisions=(col,))
        after = collisions_substep(state0, one, CpuDraws(cfg.seed, dev))
        p0, pa0, e0 = momentum_energy(state0, cfg, col.species)
        p1, _, e1 = momentum_energy(after, cfg, col.species)
        changed = float(sum(
            (getattr(after.species[s], k) != getattr(state0.species[s], k))
            .double().mean() for s in set(col.species)
            for k in ("ux",))) / len(set(col.species))
        rec = {"momentum_rel": float(np.abs(p1 - p0).max() / pa0.max()),
               "energy_rel": abs(e1 - e0) / e0, "changed_share": changed}
        conserve[col.name] = rec
        if not (rec["momentum_rel"] <= TOL_COLLIDE_MOMENTUM
                and rec["energy_rel"] <= TOL_COLLIDE_ENERGY
                and changed > 0.2):
            raise AssertionError(f"main_coulomb: {col.name} {rec}")
    del after
    vd0 = drift_difference(state0)
    with timed_fn(col_mod, "intra_species_coulomb") as intra, \
            timed_fn(col_mod, "inter_species_coulomb") as inter:
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(steps + 1)]
        marks[0].record()
        for mark in marks[1:]:
            sim.evolve(1)
            mark.record()
        marks[-1].synchronize()
        ms_steps = [marks[i].elapsed_time(marks[i + 1])
                    for i in range(steps)]
        intra_ms, inter_ms = intra.ms(), inter.ms()
    vd1 = drift_difference(sim.state)
    expect, lnL_eff = coulomb_drift_ratio(cfg.dt, steps)
    fall, fall_expect = 1 - vd1 / vd0, 1 - expect
    if not abs(fall - fall_expect) <= COULOMB_FALL_BAND * fall_expect:
        raise AssertionError(f"main_coulomb: the drift difference went "
                             f"from {vd0} to {vd1}, a fall of {fall} "
                             f"against {fall_expect}")
    for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"):
        if not bool(torch.isfinite(getattr(sim.state.fields, nm)).all()):
            raise AssertionError(f"main_coulomb: {nm} not finite")
    breakdown = profile_steps(sim, 1)
    peak = torch.cuda.max_memory_allocated()
    slots = sum(s.capacity for s in sim.state.species.values())
    del sim, state0
    torch.cuda.empty_cache()

    # float32 against float64 on the same draws at n_share^3
    small = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(coulomb_deck(n_share, 1)), dtype=torch.float64,
        device=dev)
    st64 = small.init()
    el64 = st64.species["electrons"]
    el32 = el64.replace(**{k: getattr(el64, k).float() for k in (
        "w", "ux", "uy", "uz", "x", "y", "z")})
    share = {}
    for nm, el in (("float64", el64), ("float32", el32)):
        out = col_mod.intra_species_coulomb(
            el, -Q_E, M_E, small.cfg.geometry, small.cfg.dt,
            CastDraws(small.cfg.seed, dev))
        share[nm] = float(((out.ux != el.ux) & el.alive).double().sum()
                          / el.alive.double().sum())
    if not share["float32"] >= 0.9 * share["float64"] > 0:
        raise AssertionError(f"main_coulomb: float32 changed {share}")
    emit("main_coulomb", ok=True, n_cell=(n, n, n), slots=slots,
         dt=cfg.dt, steps=steps, init_s=init_s,
         ms_per_step=sum(ms_steps) / steps,
         ms_each_step=[round(m, 3) for m in ms_steps],
         intra_ms_each=[round(m, 3) for m in intra_ms],
         inter_ms_each=[round(m, 3) for m in inter_ms],
         intra_ms_per_call=sum(intra_ms) / len(intra_ms),
         inter_ms_per_call=sum(inter_ms) / len(inter_ms),
         conservation=conserve, momentum_tol=TOL_COLLIDE_MOMENTUM,
         energy_tol=TOL_COLLIDE_ENERGY,
         drift_difference={"start": vd0, "end": vd1, "ratio": vd1 / vd0,
                           "expected_ratio": expect, "lnL_eff": lnL_eff,
                           "fall_band": COULOMB_FALL_BAND},
         changed_share_at=n_share, changed_share=share,
         device_busy_share=breakdown["device_busy_share"],
         peak_memory_bytes=peak,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    emit("main_coulomb_profile", steps=1, **breakdown)


FUSION_Q = {"dt": 17.5893e6 * Q_E, "protonboron": (5.55610759e6
                                                    + 3.12600414e6) * Q_E}
TOL_FUSION_EVENT = 1e-5


def fusion_deck(n=128, steps=10):
    """fusion-128: deuterium and tritium at 10 keV, 1e26 m^-3, 4 a cell
    each (NRandomPerCell), multiplier 60 (~5e3 D-T events a step), and
    protons at ~560 keV against boron-11 at 1 a cell each, multiplier
    100 (~3e4 events a step), alphas as products; every pair's
    probability under the 0.02 threshold; no field solve and frozen
    reactants, as tests/test_fusion.py configures its boxes; dt 1 ns."""
    sp = ""
    for nm, st, ppc, th, uz in (("deut", "hydrogen2", 4, 0.0023, 0.0),
                                ("trit", "hydrogen3", 4, 0.0019, 0.0),
                                ("prot", "hydrogen1", 1, 0.001, 0.036),
                                ("boron", "boron11", 1, 0.0003, 0.0)):
        sp += f"""
{nm}.species_type = {st}
{nm}.injection_style = NRandomPerCell
{nm}.num_particles_per_cell = {ppc}
{nm}.profile = constant
{nm}.density = 1.e26
{nm}.momentum_distribution_type = gaussian
{nm}.ux_th = {th}
{nm}.uy_th = {th}
{nm}.uz_th = {th}
{nm}.uz_m = {uz}
{nm}.do_not_push = 1
{nm}.do_not_deposit = 1
"""
    for nm, st in (("alpha", "helium4"), ("neutron", "neutron"),
                   ("alpha_pb", "helium4")):
        sp += f"""
{nm}.species_type = {st}
{nm}.injection_style = none
{nm}.do_not_push = 1
{nm}.do_not_deposit = 1
"""
    return f"""
max_step = {steps}
amr.n_cell = {n} {n} {n}
geometry.dims = 3
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = {n * 1e-6} {n * 1e-6} {n * 1e-6}
warpx.const_dt = 1.e-9
algo.maxwell_solver = none
warpx.use_filter = 0
particles.species_names = deut trit prot boron alpha neutron alpha_pb
collisions.collision_names = dt pb
dt.type = nuclearfusion
dt.species = deut trit
dt.product_species = alpha neutron
dt.fusion_multiplier = 60.
pb.type = nuclearfusion
pb.species = prot boron
pb.product_species = alpha_pb
pb.fusion_multiplier = 100.
""" + sp


CLEAN_STEPS = 3


def clean_steps(sim, *fns):
    """CLEAN_STEPS steps timed with CUDA events, with the device ms of
    each call of ``fns`` (module, name, module, name, ...); returns (ms a
    step, ms of each call of the first function, or a dict by name when
    there are several)."""
    with contextlib.ExitStack() as stack:
        timers = [stack.enter_context(timed_fn(m, nm))
                  for m, nm in zip(fns[::2], fns[1::2])]
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(CLEAN_STEPS + 1)]
        marks[0].record()
        for mark in marks[1:]:
            sim.evolve(1)
            mark.record()
        marks[-1].synchronize()
        ms = [marks[i].elapsed_time(marks[i + 1])
              for i in range(CLEAN_STEPS)]
        calls = {nm: t.ms() for nm, t in zip(fns[1::2], timers)}
    return ms, (calls[fns[1]] if len(calls) == 1 else calls)


def kinetic(m, u):
    """Kinetic energy m c^2 (gamma - 1) of proper velocities ``u`` (3, N),
    float64."""
    u2 = (u * u).sum(0) / C_LIGHT ** 2
    return m * C_LIGHT ** 2 * u2 / (1 + np.sqrt(1 + u2))


def phase_main_fusion(dev, smi, n=128, steps=10):
    """fusion-128 (``fusion_deck``), float32: ``steps`` steps with every
    call of the event kernel recorded.  Each step: the events against the
    sum of the pairs' probabilities evaluated in float64 on the same pairs
    (5 sigma over the run); every event's products against its reactants
    (momentum to TOL_FUSION_EVENT of the products' momentum, kinetic energy
    gained to TOL_FUSION_EVENT of the released energy); the reactants'
    weight lost against the products' weight (D-T: equal; p-B11: 2/3);
    every event placed (no product dropped).  Then CLEAN_STEPS steps
    without the checks: ms a step and each fusion's device ms."""
    import warpx_tpu_torch
    from warpx_tpu_torch.ops import fusion as fus
    from warpx_tpu_torch.utils.parser import Deck

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(fusion_deck(n, steps + CLEAN_STEPS + 1)),
        dtype=torch.float32, device=dev)
    sim.init()
    init_s = time.perf_counter() - t0
    cfg = sim.cfg
    by = {s.name: s for s in cfg.species}
    dV = cfg.geometry.cell_volume
    calls = []
    orig = fus.fusion_event_weight

    def record(key, u1, m1, w1, u2, m2, w2, kind, dt, dV_, fm, mr, thr,
               tgt):
        fuse, w_r = orig(key, u1, m1, w1, u2, m2, w2, kind, dt, dV_, fm, mr,
                         thr, tgt)
        # the float64 expectation on the same pairs
        d = [tuple(x.double() for x in u) for u in (u1, u2)]
        E, v, l2c = fus.collision_parameters(d[0], d[1], m1, m2)
        sig = (fus.proton_boron_cross_section(E) if kind == "protonboron"
               else fus.bosch_hale_cross_section(E, kind, m1, m2))
        p_est = (sig * v * (fm * dt / dV_) * mr.double() * l2c
                 * torch.maximum(w1, w2).double())
        if float(p_est.max()) > thr:
            raise AssertionError("main_fusion: a pair crossed the "
                                 "probability threshold")
        prob = -torch.expm1(-p_est)
        sel = fuse.nonzero().squeeze(1)
        calls.append({"kind": kind, "events": int(fuse.sum()),
                      "sum_prob": float(prob.sum()),
                      "var": float((prob * (1 - prob)).sum()),
                      "u1": torch.stack(u1)[:, sel].double().cpu().numpy(),
                      "u2": torch.stack(u2)[:, sel].double().cpu().numpy(),
                      "w_r": w_r[sel].double().cpu().numpy(),
                      "m": (m1, m2)})
        return fuse, w_r

    names = ("deut", "trit", "prot", "boron", "alpha", "neutron",
             "alpha_pb")
    checks = {"dt": [], "protonboron": []}
    fus.fusion_event_weight = record
    try:
        for _ in range(steps):
            before = {nm: (int(sim.state.species[nm].alive.sum()),
                           sim.state.species[nm].w.double().sum().item())
                      for nm in names}
            ncall = len(calls)
            sim.evolve(1)
            sp = sim.state.species
            for rec in calls[ncall:]:
                kind = rec["kind"]
                E = rec["events"]
                prods = (("alpha", "neutron") if kind == "dt"
                         else ("alpha_pb",))
                reac = ("deut", "trit") if kind == "dt" else ("prot",
                                                              "boron")
                per_event = 2 if kind == "dt" else 6
                made = {p: int(sp[p].alive.sum()) - before[p][0]
                        for p in prods}
                if any(v != per_event * E for v in made.values()):
                    raise AssertionError(f"main_fusion: {kind} made "
                                         f"{made} for {E} events")
                # per event: the first block of each product species
                blocks = []
                for p in prods:
                    n0 = before[p][0]
                    s = sp[p]
                    u = torch.stack([s.ux, s.uy, s.uz])[
                        :, n0:n0 + per_event * E].double().cpu().numpy()
                    blocks += [u[:, k * E:(k + 1) * E]
                               for k in range(0, per_event, 2)]
                m1, m2 = rec["m"]
                mp = [by[p].mass for p in prods for _ in
                      range(per_event // 2)] if kind == "dt" else [
                    by["alpha_pb"].mass] * 3
                p_in = m1 * rec["u1"] + m2 * rec["u2"]
                p_out = sum(m * u for m, u in zip(mp, blocks))
                p_scale = max(np.abs(m * u).max() for m, u in
                              zip(mp, blocks)) if E else 1.0
                k_in = kinetic(m1, rec["u1"]) + kinetic(m2, rec["u2"])
                k_out = sum(kinetic(m, u) for m, u in zip(mp, blocks))
                q = FUSION_Q[kind]
                mom_err = float(np.abs(p_out - p_in).max() / p_scale) \
                    if E else 0.0
                en_err = float(np.abs(k_out - k_in - q).max() / q) \
                    if E else 0.0
                lost = sum(before[r][1] - sp[r].w.double().sum().item()
                           for r in reac)
                gained = sum(sp[p].w.double().sum().item() - before[p][1]
                             for p in prods)
                ratio = 1.0 if kind == "dt" else 2.0 / 3.0
                w_err = abs(lost - ratio * gained) / max(abs(lost), 1e-30)
                checks[kind].append({"events": E,
                                     "sum_prob": rec["sum_prob"],
                                     "momentum_rel": mom_err,
                                     "energy_rel": en_err,
                                     "weight_rel": w_err})
                if not (mom_err <= TOL_FUSION_EVENT
                        and en_err <= TOL_FUSION_EVENT
                        and w_err <= TOL_FUSION_EVENT):
                    raise AssertionError(f"main_fusion: {kind} "
                                         f"{checks[kind][-1]}")
    finally:
        fus.fusion_event_weight = orig
    ms_steps, op_ms = clean_steps(sim, fus, "fusion_collision_update")
    yields = {}
    for kind in ("dt", "protonboron"):
        recs = [c for c in calls if c["kind"] == kind]
        got = sum(c["events"] for c in recs)
        exp_n = sum(c["sum_prob"] for c in recs)
        sig = max(sum(c["var"] for c in recs), 1.0) ** 0.5
        yields[kind] = {"events": got, "expected": exp_n, "sigma": sig,
                        "z": (got - exp_n) / sig}
        if not (abs(got - exp_n) <= 5 * sig and got > 0):
            raise AssertionError(f"main_fusion: {kind} {yields[kind]}")
    breakdown = profile_steps(sim, 1)
    emit("main_fusion", ok=True, n_cell=(n, n, n),
         slots={nm: s.capacity for nm, s in sim.state.species.items()},
         steps=steps, init_s=init_s, timed_steps=CLEAN_STEPS,
         ms_per_step=sum(ms_steps) / len(ms_steps),
         ms_each_step=[round(m, 3) for m in ms_steps],
         fusion_ms_each=[round(m, 3) for m in op_ms], yields=yields,
         worst={k: {q: max(c[q] for c in v) for q in
                    ("momentum_rel", "energy_rel", "weight_rel")}
                for k, v in checks.items()},
         event_tol=TOL_FUSION_EVENT,
         device_busy_share=breakdown["device_busy_share"],
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    emit("main_fusion_profile", steps=1, **breakdown)


def mcc128_deck(n=128, steps=10):
    """mcc-dsmc-128: a 1 um-cell box (no field solve): electrons (~700
    eV, 4 a cell) on a 1e22 m^-3 helium background with MCC elastic
    scattering and ionization into He+ ('hep'); He+ and He ('he') at 4 a
    cell each with DSMC elastic and charge exchange; He+ stopping on a
    background of electrons (1e24 m^-3, 5e4 K); the tables of
    ``write_collision_tables``."""
    sp = ""
    for nm, st, q, th, dens in (
            ("electrons", "electron", "", 0.03, 1e20),
            ("hep", "helium", "hep.charge = q_e\n", 0.0003, 1e20),
            ("he", "helium", "he.charge = 0.\n", 0.00001, 1e22)):
        sp += f"""
{nm}.species_type = {st}
{q}{nm}.injection_style = NUniformPerCell
{nm}.num_particles_per_cell_each_dim = 2 2 1
{nm}.profile = constant
{nm}.density = {dens}
{nm}.momentum_distribution_type = gaussian
{nm}.ux_th = {th}
{nm}.uy_th = {th}
{nm}.uz_th = {th}
{nm}.do_not_deposit = 1
"""
    return f"""
max_step = {steps}
amr.n_cell = {n} {n} {n}
geometry.dims = 3
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = {n * 1e-6} {n * 1e-6} {n * 1e-6}
warpx.const_dt = 2.e-12
algo.maxwell_solver = none
warpx.use_filter = 0
particles.species_names = electrons hep he
collisions.collision_names = dsmc1 mcc1 stop_i
dsmc1.type = dsmc
dsmc1.species = hep he
dsmc1.scattering_processes = elastic charge_exchange
dsmc1.elastic_cross_section = d_el.dat
dsmc1.charge_exchange_cross_section = d_cx.dat
mcc1.type = background_mcc
mcc1.species = electrons
mcc1.background_density = 1.e22
mcc1.background_temperature = 300.
mcc1.ionization_species = hep
mcc1.scattering_processes = elastic ionization
mcc1.elastic_cross_section = el.dat
mcc1.ionization_cross_section = iz.dat
mcc1.ionization_energy = 24.6
stop_i.type = background_stopping
stop_i.species = hep
stop_i.background_type = electrons
stop_i.background_density = 1.e24
stop_i.background_temperature = 5.e4
""" + sp


EPS0 = 8.8541878128e-12
K_B = 1.380649e-23


def stopping_scale_host(q, m, n_b, T_K, M_bg, dt):
    """exp(-alpha dt) of a species slowing on an electron background, the
    NRL low-velocity rate of BackgroundStopping.cpp:141-147 evaluated on
    the host in float64 from its SI form."""
    T = K_B * T_K
    vth = np.sqrt(3 * T / M_bg)
    wp = np.sqrt(n_b * Q_E ** 2 / (EPS0 * M_bg))
    ll = np.log(12 * np.pi / abs(q / Q_E) * n_b * (vth / wp) ** 3)
    alpha = (np.sqrt(2) * n_b * q ** 2 * Q_E ** 2 * np.sqrt(M_bg) * ll
             / (12 * np.pi ** 1.5 * EPS0 ** 2 * m * T ** 1.5))
    return float(np.exp(-alpha * dt))


def phase_main_mcc_dsmc(dev, smi, n=128, steps=10):
    """mcc-dsmc-128 (``mcc128_deck``), float32, ``steps`` steps, each MCC
    and ionization pass and the stopping recorded: the scattered electrons
    and the ionizations of the run within 5 sigma of N p_coll and of the
    sum of the ionization probabilities (float64, on the same electrons);
    He+ scaled by the host's closed form of the stopping to 1e-5; every
    ionization placed.  After the run one DSMC collision with charge
    exchange alone (its cross section x 1000) swaps momenta: each changed
    He+ momentum is an old He momentum and the reverse.  Then CLEAN_STEPS
    steps without the checks: ms a step and each operator's device ms."""
    from warpx_tpu_torch.core.step import collisions_substep
    from warpx_tpu_torch.ops import dsmc as dsmc_mod
    from warpx_tpu_torch.ops import mcc as mcc_mod
    from warpx_tpu_torch.ops import stopping as stop_mod

    tables = tempfile.mkdtemp()
    try:
        write_collision_tables(tables)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sim = deck_sim(mcc128_deck(n, steps + CLEAN_STEPS + 1), tables, dev,
                       torch.float32)
        sim.init()
        init_s = time.perf_counter() - t0
        cfg = sim.cfg
        col_i = next(c for c in cfg.collisions if c.kind == "background_mcc")
        stats = {"scatter": [0, 0.0, 0.0], "ionize": [0, 0.0, 0.0]}
        stop_err = [0.0]
        orig = (mcc_mod.apply_mcc_scattering, mcc_mod.apply_mcc_ionization,
                stop_mod.apply_background_stopping)

        def scatter(key, sp, *a, **kw):
            out = orig[0](key, sp, *a, **kw)
            moved = int((out.ux != sp.ux).sum())
            nal = float(sp.alive.sum())
            p = kw["p_coll"]
            s = stats["scatter"]
            s[0] += moved
            s[1] += nal * p
            s[2] += nal * p * (1 - p)
            return out

        def ionize(key, sp_e, sp_ion, *a, **kw):
            out = orig[1](key, sp_e, sp_ion, *a, **kw)
            u = torch.stack([sp_e.ux, sp_e.uy, sp_e.uz]).double() / C_LIGHT
            u2 = (u * u).sum(0)
            e_ev = u2 / (1 + torch.sqrt(1 + u2)) * M_E * C_LIGHT ** 2 / Q_E
            proc = kw["proc"]
            sig = mcc_mod._sigma_at(e_ev, proc.energies, proc.sigmas)
            nu = 1e22 * sig * torch.sqrt(u2) * C_LIGHT / kw["nu_max_ioniz"]
            p = kw["p_coll_ioniz"] * torch.clamp(nu, max=1.0) * sp_e.alive
            made = int(out[1].alive.sum() - sp_ion.alive.sum())
            if made != int(out[0].alive.sum() - sp_e.alive.sum()):
                raise AssertionError("main_mcc_dsmc: secondaries and ions "
                                     "differ")
            s = stats["ionize"]
            s[0] += made
            s[1] += float(p.sum())
            s[2] += float((p * (1 - p)).sum())
            return out

        def stopping(sp, *a, **kw):
            out = orig[2](sp, *a, **kw)
            ref = stopping_scale_host(kw["q"], kw["m"], 1e24, 5e4,
                                      kw["M_bg"], kw["dt"])
            keep = sp.alive & (sp.ux != 0)
            got = (out.ux[keep].double() / sp.ux[keep].double())
            stop_err[0] = max(stop_err[0],
                              float((got / ref - 1).abs().max()))
            return out

        mcc_mod.apply_mcc_scattering = scatter
        mcc_mod.apply_mcc_ionization = ionize
        stop_mod.apply_background_stopping = stopping
        try:
            sim.evolve(steps)
        finally:
            (mcc_mod.apply_mcc_scattering, mcc_mod.apply_mcc_ionization,
             stop_mod.apply_background_stopping) = orig
        ms_steps, op_ms = clean_steps(
            sim, mcc_mod, "mcc_collision_update", dsmc_mod,
            "dsmc_collision_update", stop_mod, "stopping_collision_update")
        checks = {}
        for nm, (got, exp_n, var) in stats.items():
            sig = max(var, 1.0) ** 0.5
            checks[nm] = {"events": got, "expected": exp_n, "sigma": sig,
                          "z": (got - exp_n) / sig}
            if not (abs(got - exp_n) <= 5 * sig and got > 0):
                raise AssertionError(f"main_mcc_dsmc: {nm} {checks[nm]}")
        if not stop_err[0] <= 1e-5:
            raise AssertionError(f"main_mcc_dsmc: stopping {stop_err[0]} "
                                 "off its closed form")
        # charge exchange alone: a swap of momenta
        col_d = next(c for c in cfg.collisions if c.kind == "dsmc")
        # (its cross section x 1000, so that most pairs exchange)
        cx = dataclasses.replace(col_d, processes=tuple(
            dataclasses.replace(p, sigmas=tuple(1e3 * v for v in p.sigmas))
            for p in col_d.processes if p.kind == "charge_exchange"))
        st = sim.state
        after = collisions_substep(st, dataclasses.replace(
            cfg, collisions=(cx,)), sim.draws)
        swaps = {}
        for a, b in (("hep", "he"), ("he", "hep")):
            old, new = st.species[a], after.species[a]
            ch = (new.ux != old.ux) & old.alive
            vals = new.ux[ch]
            pool = st.species[b].ux[st.species[b].alive]
            hits = torch.isin(vals, pool)
            swaps[a] = {"changed": int(ch.sum()),
                        "partner_values": int(hits.sum())}
            if not (int(ch.sum()) > 0 and bool(hits.all())):
                raise AssertionError(f"main_mcc_dsmc: charge exchange "
                                     f"{swaps}")
        del after
        breakdown = profile_steps(sim, 1)
        emit("main_mcc_dsmc", ok=True, n_cell=(n, n, n),
             slots={nm: s.capacity for nm, s in sim.state.species.items()},
             alive_end={nm: int(s.alive.sum())
                        for nm, s in sim.state.species.items()},
             steps=steps, init_s=init_s, timed_steps=CLEAN_STEPS,
             ms_per_step=sum(ms_steps) / len(ms_steps),
             ms_each_step=[round(m, 3) for m in ms_steps],
             op_ms_per_call={k: sum(v) / len(v) for k, v in op_ms.items()},
             events=checks, stopping_max_rel_err=stop_err[0],
             charge_exchange=swaps, mcc_ionization_species=col_i.
             ionization_species,
             device_busy_share=breakdown["device_busy_share"],
             peak_memory_bytes=torch.cuda.max_memory_allocated(),
             device=torch.cuda.get_device_name(0), nvidia_smi=smi)
        emit("main_mcc_dsmc_profile", steps=1, **breakdown)
    finally:
        shutil.rmtree(tables, ignore_errors=True)


# ---- injection, initial conditions, external fields, quartic shapes -------

# every injection style and momentum distribution of Queue A 11.2 but the
# openPMD file (no h5py on the card): one particle, a list, Maxwell-
# Boltzmann with a drift along -y, Maxwell-Juttner with a drift along z,
# the uniform cuboid, the parsed Gaussian, a parsed temperature and a
# parsed drift (tests/test_torch_injection_styles.py)
INJECTION_SPECIES = """
particles.species_names = single multi mb mj un gp tp bp
single.species_type = electron
single.injection_style = SingleParticle
single.single_particle_pos = 1.e-6 -2.e-6 3.e-6
single.single_particle_u = 0.1 -0.2 0.5
single.single_particle_weight = 1.e10
multi.species_type = positron
multi.injection_style = MultipleParticles
multi.multiple_particles_pos_x = -3.e-6 1.e-6 4.e-6
multi.multiple_particles_pos_y = 0. 2.e-6 -1.e-6
multi.multiple_particles_pos_z = 5.e-6 -5.e-6 0.
multi.multiple_particles_ux = 0.3 0. -0.1
multi.multiple_particles_uy = 0. 0.2 0.
multi.multiple_particles_uz = 0.1 0.1 0.7
multi.multiple_particles_weight = 1.e9 2.e9 3.e9
mb.species_type = electron
mb.injection_style = NRandomPerCell
mb.num_particles_per_cell = 2
mb.profile = constant
mb.density = 1.e24
mb.momentum_distribution_type = maxwell_boltzmann
mb.theta = 1.e-3
mb.beta = 0.2
mb.bulk_vel_dir = -y
mj.species_type = electron
mj.injection_style = NUniformPerCell
mj.num_particles_per_cell_each_dim = 1 1 1
mj.profile = constant
mj.density = 1.e24
mj.momentum_distribution_type = maxwell_juttner
mj.theta = 0.5
mj.beta = 0.3
mj.bulk_vel_dir = z
un.species_type = proton
un.injection_style = NUniformPerCell
un.num_particles_per_cell_each_dim = 1 1 1
un.profile = constant
un.density = 1.e24
un.momentum_distribution_type = uniform
un.ux_min = -0.002
un.ux_max = 0.003
un.uz_min = 0.01
un.uz_max = 0.011
gp.species_type = electron
gp.injection_style = NUniformPerCell
gp.num_particles_per_cell_each_dim = 1 1 1
gp.profile = constant
gp.density = 1.e24
gp.momentum_distribution_type = gaussian_parse_momentum_function
gp.momentum_function_ux_m(x,y,z) = "1.e3*z"
gp.momentum_function_ux_th(x,y,z) = "0.01 + 1.e3*abs(x)"
gp.momentum_function_uz_th(x,y,z) = "0.02"
tp.species_type = electron
tp.injection_style = NUniformPerCell
tp.num_particles_per_cell_each_dim = 1 1 1
tp.profile = constant
tp.density = 1.e24
tp.momentum_distribution_type = maxwell_juttner
tp.theta_distribution_type = parser
tp.theta_function(x,y,z) = "0.2 + heaviside(x,0)"
bp.species_type = electron
bp.injection_style = NUniformPerCell
bp.num_particles_per_cell_each_dim = 1 1 1
bp.profile = constant
bp.density = 1.e24
bp.momentum_distribution_type = maxwell_boltzmann
bp.theta = 1.e-4
bp.beta_distribution_type = parser
bp.beta_function(x,y,z) = "-0.2 + 0.4 * heaviside(z,0)"
bp.bulk_vel_dir = -y
"""

THERMAL_SPECIES = """
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1 1
electrons.profile = constant
electrons.density = 1.e24
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.05
electrons.uy_th = 0.05
electrons.uz_th = 0.05
"""

# the initial grid fields of tests/test_torch_ext_grid.py
EXT_GRID = {
    "constant": """
warpx.E_ext_grid_init_style = constant
warpx.E_external_grid = 1.e9 -2.e9 3.e9
warpx.B_ext_grid_init_style = constant
warpx.B_external_grid = 0.5 0. 1.
""",
    "parse": """
my_constants.k = 3.e5
warpx.E_ext_grid_init_style = parse_E_ext_grid_function
warpx.Ex_external_grid_function(x,y,z) = "1.e9 * sin(k * z)"
warpx.Ey_external_grid_function(x,y,z) = "2.e9 * cos(k * x) * (1 + y / 1.e-5)"
warpx.Ez_external_grid_function(x,y,z) = "1.e8 * x * 1.e5"
warpx.B_ext_grid_init_style = parse_B_ext_grid_function
warpx.Bx_external_grid_function(x,y,z) = "0.2 * z * 1.e5"
warpx.By_external_grid_function(x,y,z) = "0.3 + 0.1 * sin(k * x)"
warpx.Bz_external_grid_function(x,y,z) = "1."
""",
}

# protons emitted along +z from z = -7 um (u_m = 2 u_th: the second
# rejection scheme) into Maxwell-Boltzmann electrons under Bz = 1 T
# (tests/test_torch_flux_injection.py)
FLUX_16_DECK = """
max_step = 3
amr.n_cell = 16 16 16
geometry.dims = 3
geometry.prob_lo = -8.e-6 -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6  8.e-6
warpx.B_ext_grid_init_style = constant
warpx.B_external_grid = 0. 0. 1.
particles.species_names = electrons protons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1 1
electrons.profile = constant
electrons.density = 1.e24
electrons.momentum_distribution_type = maxwell_boltzmann
electrons.theta = 1.e-4
protons.species_type = proton
protons.injection_style = NFluxPerCell
protons.num_particles_per_cell = 2
protons.surface_flux_pos = -7.e-6
protons.flux_normal_axis = z
protons.flux_direction = 1
protons.flux = 3.e30
protons.momentum_distribution_type = gaussianflux
protons.uz_m = 0.01
protons.ux_th = 0.005
protons.uy_th = 0.005
protons.uz_th = 0.005
"""


def box_deck(ndim, n, steps, body, bounded=False):
    """A 16 um box (periodic, or with PEC walls and reflecting particles
    along its last axis) of n^ndim cells, per particle, ``steps`` steps,
    and ``body``'s keys."""
    axes = ndim - 1
    faces = " ".join(["periodic"] * axes + ["pec" if bounded else "periodic"])
    parts = " ".join(["periodic"] * axes
                     + ["reflecting" if bounded else "periodic"])
    return (f"max_step = {steps}\namr.n_cell = {' '.join([str(n)] * ndim)}\n"
            f"geometry.dims = {ndim}\n"
            f"geometry.prob_lo = {' '.join(['-8.e-6'] * ndim)}\n"
            f"geometry.prob_hi = {' '.join(['8.e-6'] * ndim)}\n"
            f"boundary.field_lo = {faces}\nboundary.field_hi = {faces}\n"
            f"boundary.particle_lo = {parts}\n"
            f"boundary.particle_hi = {parts}\nwarpx.cfl = 0.9\n"
            "tpu.tiled_particles = off\n" + body)


def injection_parity_decks():
    """name -> deck text of injection_parity's card-against-CPU runs."""
    decks = {"styles_16^3": box_deck(3, 16, 3, INJECTION_SPECIES)}
    for style, keys in EXT_GRID.items():
        decks[f"ext_{style}_16^3"] = box_deck(3, 16, 3,
                                              keys + THERMAL_SPECIES)
        decks[f"ext_{style}_32^2_pec"] = box_deck(2, 32, 3,
                                                  keys + THERMAL_SPECIES,
                                                  bounded=True)
    order4 = "algo.particle_shape = 4\n" + THERMAL_SPECIES
    decks["order4_16^3"] = box_deck(3, 16, 3, order4)
    decks["order4_32^2"] = box_deck(2, 32, 3, order4)
    decks["order4_lwfa_32x64"] = LWFA_32X64_DECK.replace(
        "algo.particle_shape = 3", "algo.particle_shape = 4").replace(
        "max_step = 12", "max_step = 4") + "tpu.tiled_particles = off\n"
    decks["flux_16^3"] = FLUX_16_DECK
    return decks


LASY_E_MAX = 1.0e12
LASY_WAVELENGTH = 1.0e-6
LASY_WAIST = 5.0e-6
LASY_TAU = 15.0e-15
LASY_T_PEAK = 60.0e-15


def lasy_test_data(cartesian):
    """The Gaussian envelope of tests/test_laser_from_file.py (_gauss_env,
    f_dist = 0) on its grids, as a ``LasyData`` built from arrays."""
    from warpx_tpu_torch.core.laser_file import LasyData

    omega0 = 2.0 * math.pi * C_LIGHT / LASY_WAVELENGTH
    t = np.linspace(0.0, 120e-15, 241)

    def env(x2):
        return (LASY_E_MAX * np.exp(-((t[:, None] - LASY_T_PEAK) ** 2)
                                    / LASY_TAU ** 2 - x2 / LASY_WAIST ** 2)
                * np.exp(1j * omega0 * LASY_T_PEAK))

    if cartesian:
        y = np.linspace(-3 * LASY_WAIST, 3 * LASY_WAIST, 41)
        x = np.linspace(-4 * LASY_WAIST, 4 * LASY_WAIST, 81)
        data = env((x[None, None, :] ** 2
                    + y[None, :, None] ** 2).reshape(1, -1))
        return LasyData(cartesian=True, t_min=0.0, t_max=120e-15,
                        data=data.reshape(241, 41, 81), x_min=x[0],
                        x_max=x[-1], y_min=y[0], y_max=y[-1])
    r = np.linspace(0.0, 4 * LASY_WAIST, 61)
    return LasyData(cartesian=False, t_min=0.0, t_max=120e-15,
                    data=env(r[None, :] ** 2)[None], r_min=0.0, r_max=r[-1])


def lasy_parity(dev):
    """``lasy_amplitude`` of the cartesian and the thetaMode envelopes on
    the card against the CPU (1e-12 of e_max) and against the Gaussian
    profile (2e-2 of e_max, tests/test_laser_from_file.py's bound)."""
    from warpx_tpu_torch.core.config import LaserConfig
    from warpx_tpu_torch.core.laser import fill_amplitude
    from warpx_tpu_torch.core.laser_file import lasy_amplitude

    kw = dict(name="lasy", e_max=LASY_E_MAX, wavelength=LASY_WAVELENGTH,
              profile_waist=LASY_WAIST, profile_duration=LASY_TAU,
              profile_t_peak=LASY_T_PEAK, polarization=(1.0, 0.0, 0.0))
    lf = LaserConfig(profile="from_file", **kw)
    lg = LaserConfig(profile="gaussian", **kw)
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.uniform(-3 * LASY_WAIST, 3 * LASY_WAIST, 4096))
    Y = torch.from_numpy(rng.uniform(-2.5 * LASY_WAIST, 2.5 * LASY_WAIST,
                                     4096))
    out = {}
    for geom in ("cartesian", "thetaMode"):
        ld = lasy_test_data(geom == "cartesian")
        card_err = gauss_err = 0.0
        for t in (20e-15, 55e-15, 60e-15, 90e-15):
            cpu = lasy_amplitude(ld, lf, X, Y, t)
            card = lasy_amplitude(ld, lf, X.to(dev), Y.to(dev), t).cpu()
            card_err = max(card_err, float((card - cpu).abs().max())
                           / LASY_E_MAX)
            ref = fill_amplitude(lg, 3, X, Y, t)
            gauss_err = max(gauss_err, float((card - ref).abs().max())
                            / LASY_E_MAX)
        if not (card_err <= TOL[torch.float64] and gauss_err < 2e-2):
            raise AssertionError(f"injection_parity: lasy {geom} differs by "
                                 f"{card_err} (CPU), {gauss_err} (Gaussian)")
        out[geom] = {"card_vs_cpu": card_err, "vs_gaussian": gauss_err}
    return out


def gaussianflux_moments(u_m, u_th):
    """(mean, variance, fourth central moment) of u G(u - u_m), u >= 0, by
    quadrature (tests/test_flux_injection.py's form)."""
    trap = getattr(np, "trapezoid", None) or np.trapz
    uu = np.linspace(0.0, abs(u_m) + 12 * u_th, 200_001)
    pdf = uu * np.exp(-((uu - abs(u_m)) ** 2) / (2 * u_th ** 2))
    pdf /= trap(pdf, uu)
    mean = trap(uu * pdf, uu)
    var = trap((uu - mean) ** 2 * pdf, uu)
    m4 = trap((uu - mean) ** 4 * pdf, uu)
    return mean, var, m4


FLUX_SIGMAS = 5.0


def flux_statistics(dev):
    """One emission of 2^20 particles on the card's own generator
    (``utils/draws.py``; its stream differs from the CPU's) for u_m = 0
    (the first rejection scheme) and u_m = 2 u_th (the second), float64:
    the count exact, the weights flux * area / ppc * dt exactly, every
    particle within one step's flight of the plane, the normal momentum's
    mean and variance within FLUX_SIGMAS standard errors of the
    gaussianflux distribution's, the tangential ones of their Gaussians'."""
    from warpx_tpu_torch.core.config import SpeciesConfig
    from warpx_tpu_torch.core.flux_injection import make_flux_injector
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.core.injection import inject_species
    from warpx_tpu_torch.utils.draws import Draws

    geom = Geometry(ndim=3, n_cell=(512, 512, 8), prob_lo=(0.0,) * 3,
                    prob_hi=(51.2e-6, 51.2e-6, 8e-7), periodic=(True,) * 3)
    dt = 1e-16
    out = {}
    for seed, (scheme, (u_m, u_th)) in enumerate((
            ("first", (0.0, 0.01)), ("second", (0.02, 0.01)))):
        sp = SpeciesConfig(name="p", charge=Q_E, mass=M_P,
                           injection_style="nfluxpercell",
                           num_particles_per_cell=4, surface_flux_pos=2e-7,
                           flux_normal_axis="z", flux_direction=1,
                           flux=6e30, ux=0.003, uy=-0.002, uz=u_m,
                           ux_th=0.02, uy_th=0.05, uz_th=u_th)
        npart = 4 * 512 * 512
        empty = inject_species(sp, geom, None, dtype=torch.float64,
                               device=dev, capacity=npart)
        inject = make_flux_injector(sp, geom, dt, torch.float64, dev)
        got = inject(empty, 0.0, Draws(17 + seed, dev))
        n = int(got.alive.sum())
        w_exp = torch.full((1,), sp.flux, dtype=torch.float64,
                           device=dev) * (geom.dx[0] * geom.dx[1] / 4 * dt)
        weights_exact = bool((got.w == w_exp).all())
        un, ut = got.uz / C_LIGHT, (got.ux / C_LIGHT, got.uy / C_LIGHT)
        gam = torch.sqrt(1 + (got.ux ** 2 + got.uy ** 2 + got.uz ** 2)
                         / C_LIGHT ** 2)
        # the flight along the normal: 0 <= z - plane <= v_z dt (with
        # float64 roundoff of z)
        dz = got.z - sp.surface_flux_pos
        flight_ok = bool(((dz >= -1e-21)
                          & (dz <= got.uz / gam * dt * (1 + 1e-12) + 1e-21))
                         .all())
        mean, var, m4 = gaussianflux_moments(u_m, u_th)
        z = {"normal_mean": (float(un.mean()) - mean) / math.sqrt(var / n),
             "normal_var": (float(un.var()) - var)
             / math.sqrt((m4 - var ** 2) / n)}
        for nm, u, mu, s in (("ux", ut[0], sp.ux, sp.ux_th),
                             ("uy", ut[1], sp.uy, sp.uy_th)):
            z[f"{nm}_mean"] = (float(u.mean()) - mu) / (s / math.sqrt(n))
            z[f"{nm}_var"] = (float(u.var()) - s * s) / (
                s * s * math.sqrt(2.0 / n))
        if not (n == npart and weights_exact and flight_ok
                and all(abs(v) <= FLUX_SIGMAS for v in z.values())):
            raise AssertionError(f"injection_parity: flux {scheme} scheme: "
                                 f"{n} of {npart}, weights {weights_exact}, "
                                 f"flight {flight_ok}, z {z}")
        out[scheme] = {"u_m": u_m, "u_th": u_th, "n": n, "z": z,
                       "weights_exact": weights_exact,
                       "within_one_flight": flight_ok}
    return out


def phase_injection_parity(dev):
    """Queue A 11.2 and 11.5 in float64, card against CPU: every injection
    style and momentum distribution (16^3), constant and parsed external
    grid fields (periodic 16^3, PEC-walled 32^2), order-4 shapes (16^3,
    32^2, the bounded 32 x 64 laser-wakefield deck), all per particle, and
    the 16^3 flux deck on the numbers of one CPU generator (``CpuDraws``):
    3 steps (4 on the laser-wakefield deck), species and fields within
    1e-9, checksums within 1e-9, the initial particles identical (both
    inject on the host from the seed); ``lasy_amplitude`` card against CPU;
    then the plane emission on the card's own generator, held
    statistically (``flux_statistics``)."""
    runs = {}
    for name, text in injection_parity_decks().items():
        card = stochastic_run(text, dev, torch.float64, steps=0)
        cpu = stochastic_run(text, "cpu", torch.float64, steps=0)
        init_err = states_agree(card, cpu, 0.0, f"injection_parity {name} "
                                "init")
        card.evolve()
        cpu.evolve()
        if card.binned or card.state.step != card.cfg.max_step:
            raise AssertionError(f"injection_parity {name}: binned "
                                 f"{card.binned}, step {card.state.step}")
        worst = states_agree(card, cpu, 1e-9, f"injection_parity {name}")
        worst_sum = checksums_agree(card.checksums(), cpu.checksums(), 1e-9,
                                    f"injection_parity {name}")
        runs[name] = {"steps": card.state.step, "bounded": card.is_bounded,
                      "order": card.cfg.particle_shape,
                      "init_max_rel_err": init_err, "max_rel_err": worst,
                      "checksum_max_rel_err": worst_sum,
                      "alive": {nm: int(sp.alive.sum()) for nm, sp in
                                card.state.species.items()}}
    emit("injection_parity", ok=True, run_tol=1e-9, runs=runs,
         lasy=lasy_parity(dev), flux_statistics=flux_statistics(dev),
         flux_sigmas=FLUX_SIGMAS)


FLUX_STEPS = 10


def flux_cfg(n=128, steps=FLUX_STEPS):
    """flux-128: uniform-128's plasma (``main_cfg``) loaded
    Maxwell-Boltzmann at its thermal spread (theta = 0.01^2), Bz = 1 T on
    the grid (warpx.B_ext_grid_init_style = constant), and protons emitted
    along +z from the plane one cell above prob_lo: 2 a surface cell a
    step (32,768 at n = 128), a flux of n_e 0.01 c, u_m 0.01, u_th 0.005;
    per particle (the binned gates send a flux species there, as the JAX
    package's bounded gate does); a warm step, ``steps`` timed steps and a
    profiled one."""
    from warpx_tpu_torch.core.config import SpeciesConfig

    cfg = main_cfg(n, steps + 2)
    plasma = tuple(dataclasses.replace(
        sp, momentum_distribution="maxwell_boltzmann", theta=0.01 ** 2)
        for sp in cfg.species)
    geom = cfg.geometry
    protons = SpeciesConfig(
        name="protons", charge=Q_E, mass=M_P, species_type="proton",
        injection_style="nfluxpercell", num_particles_per_cell=2,
        surface_flux_pos=geom.prob_lo[2] + geom.dx[2], flux_normal_axis="z",
        flux_direction=1, flux=plasma[0].density * 0.01 * C_LIGHT,
        momentum_distribution="gaussianflux", uz=0.01, ux_th=0.005,
        uy_th=0.005, uz_th=0.005)
    return dataclasses.replace(cfg, species=plasma + (protons,),
                               b_ext_grid=("constant", (0.0, 0.0, 1.0)),
                               tiled_particles="auto")


def phase_main_flux(dev, smi, n=128, steps=FLUX_STEPS):
    """flux-128 (``flux_cfg``), float32, per particle: a warm step,
    ``steps`` steps timed with CUDA events and the injector's device ms
    (``timed_fn``), one profiled step (busy share); the protons alive
    exactly 32,768 a step (none dropped), their weights flux * area / ppc
    * dt, the plasma all alive, Bz held, finite fields; no fused launch
    (K1 stays at 0: the path is per particle, as in the JAX package)."""
    import warpx_tpu_torch
    from warpx_tpu_torch.core.flux_injection import _per_step_count
    from warpx_tpu_torch.ops import fused_pic as fp

    cfg = flux_cfg(n, steps)
    geom = cfg.geometry
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    if sim.binned:
        raise AssertionError("main_flux took the tile-binned step")
    fp.binned_push_deposit.launches = 0
    sim.init()
    bz0 = float(sim.state.fields.Bz.double().mean())
    sim.evolve(1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    with timed_fn(sim, "_do_flux_injection") as inj:
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(steps + 1)]
        marks[0].record()
        for mark in marks[1:]:
            sim.evolve(1)
            mark.record()
        marks[-1].synchronize()
        ms_steps = [marks[i].elapsed_time(marks[i + 1])
                    for i in range(steps)]
        inj_ms = inj.ms()
    breakdown = profile_steps(sim, 1)
    peak = torch.cuda.max_memory_allocated()
    k1 = fp.binned_push_deposit.launches
    sp_cfg = cfg.species[-1]
    per_step, _ = _per_step_count(sp_cfg, geom)
    pr = sim.state.species["protons"]
    emitted = per_step * sim.state.step
    alive = int(pr.alive.sum())
    w_fac = geom.dx[0] * geom.dx[1] / sp_cfg.num_particles_per_cell * cfg.dt
    w_exp = torch.full((1,), sp_cfg.flux, dtype=torch.float32,
                       device=dev) * w_fac
    w_live = pr.w[pr.alive]
    weights_exact = bool((w_live == w_exp).all())
    w_rel = abs(float(w_exp) / (sp_cfg.flux * w_fac) - 1)
    plasma = {s.name: int(sim.state.species[s.name].alive.sum())
              for s in cfg.species[:-1]}
    finite = all(bool(torch.isfinite(getattr(sim.state.fields, nm)).all())
                 for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy",
                            "jz"))
    bz1 = float(sim.state.fields.Bz.double().mean())
    if not (alive == emitted and weights_exact and w_rel < 2 ** -22
            and all(v == n ** 3 * 2 for v in plasma.values()) and finite
            and k1 == 0 and abs(bz1 - 1.0) < 1e-3 and bz0 == 1.0):
        raise AssertionError(
            f"main_flux: {alive} protons of {emitted}, weights exact "
            f"{weights_exact} ({w_rel}), plasma {plasma}, finite {finite}, "
            f"K1 {k1}, Bz {bz0} -> {bz1}")
    ms_step = sum(ms_steps) / steps
    n_mean = sum(plasma.values()) + alive
    emit("main_flux", ok=True, n_cell=geom.n_cell, path="per_particle",
         fused_launches=k1, steps_timed=steps, ms_per_step=ms_step,
         ms_each_step=[round(m, 3) for m in ms_steps],
         pushes_per_s=n_mean / (ms_step * 1e-3),
         injector_ms_each=[round(m, 4) for m in inj_ms],
         injector_ms_per_step=sum(inj_ms) / len(inj_ms),
         emitted_per_step=per_step, protons_alive=alive,
         protons_expected=emitted, dropped=emitted - alive,
         capacity=pr.capacity, weights_exact=weights_exact,
         weight_rel_to_float64=w_rel, plasma_alive=plasma,
         mean_bz={"start": bz0, "end": bz1}, init_s=init_s,
         device_busy_share=breakdown["device_busy_share"],
         peak_memory_bytes=peak, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi)
    emit("main_flux_profile", steps=1, **breakdown)


LWFA_LASY_PLAN = dict(warm=4, timed=8, counted=2, interval=16)
LASY_TOL = 2e-2  # of e_max: tests/test_laser_from_file.py's bound
LASY_TOL_PEAK = 1e-3  # of the largest Gaussian amplitude the run met


def lwfa_lasy_data(laser, geom, t_max=60e-15, dt_env=0.05e-15,
                   dx_env=0.05e-6):
    """A lasy envelope of the deck's own Gaussian laser (its focal
    distance, Gouy phase and all) at the antenna plane: conj(G) e^{i omega
    t} of the port's complex Gaussian field G (``core/laser.py::
    gaussian_field``), so that Re(envelope e^{-i omega t}) is the
    Gaussian's amplitude, on a grid of (t, y, x) with two rows along y
    (the 2D field does not depend on it)."""
    from warpx_tpu_torch.core.laser import gaussian_field
    from warpx_tpu_torch.core.laser_file import LasyData

    omega = 2.0 * math.pi * C_LIGHT / laser.wavelength
    x = np.arange(geom.prob_lo[0] - 1e-6, geom.prob_hi[0] + 1e-6 + dx_env / 2,
                  dx_env)
    t = np.arange(0.0, t_max + dt_env / 2, dt_env)
    X = torch.from_numpy(x)
    rows = np.stack([(torch.conj(gaussian_field(laser, 2, X,
                                                torch.zeros_like(X), ti))
                      * np.exp(1j * omega * ti)).numpy() for ti in t])
    data = np.repeat(rows[:, None, :], 2, axis=1)
    return LasyData(cartesian=True, t_min=0.0, t_max=float(t[-1]), data=data,
                    x_min=float(x[0]), x_max=float(x[-1]), y_min=-0.5e-6,
                    y_max=0.5e-6)


def write_lasy(path, ld):
    """``ld`` as a lasy file (the layout of tests/test_laser_from_file.py's
    writer)."""
    import h5py

    nt, ny, nx = ld.data.shape
    with h5py.File(path, "w") as fh:
        ds = fh.create_group("data/0/meshes").create_dataset(
            "laserEnvelope", data=ld.data)
        ds.attrs["geometry"] = np.bytes_("cartesian")
        ds.attrs["gridSpacing"] = np.array([
            (ld.t_max - ld.t_min) / (nt - 1), (ld.y_max - ld.y_min) / (ny - 1),
            (ld.x_max - ld.x_min) / (nx - 1)])
        ds.attrs["gridGlobalOffset"] = np.array([ld.t_min, ld.y_min,
                                                 ld.x_min])
        ds.attrs["position"] = np.zeros(3)


def phase_main_lwfa_lasy(dev, smi, k1c_row, k3_row, nx=2048, nz=8192):
    """lwfa2d-2048x8192-lasy: main_lwfa_deck's deck at 'mixed' with
    ``laser1.profile = from_file``, its lasy envelope sampled from the
    deck's own Gaussian laser (``lwfa_lasy_data``); written to a file and
    read where h5py is installed, else handed to the loader's cache
    (``core/laser_file.py::_CACHE``: the card has no h5py); 20 steps
    through K1c and K3 driven as main_lwfa is (``run_lwfa_path``), every
    step's antenna amplitudes held against the Gaussian profile's at the
    same positions and time (LASY_TOL of e_max, LASY_TOL_PEAK of the
    largest amplitude), K1c's device ms a launch; adds this path's
    launches to K1c's ('mixed') and K3's rows."""
    import importlib.util

    import warpx_tpu_torch
    from warpx_tpu_torch.core import bounded_step as bs_mod
    from warpx_tpu_torch.core import laser as laser_mod
    from warpx_tpu_torch.core import laser_file
    from warpx_tpu_torch.core.deck import config_from_deck
    from warpx_tpu_torch.utils.parser import Deck

    steps = lwfa_steps(LWFA_LASY_PLAN)
    gauss_text = lwfa_deck_text(nx, nz, steps, "mixed")
    gauss = config_from_deck(Deck.from_string(gauss_text))
    t0 = time.perf_counter()
    ld = lwfa_lasy_data(gauss.lasers[0], gauss.geometry)
    build_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp()
    path = str(pathlib.Path(tmp) / "lwfa_gaussian_lasy.h5")
    have_h5py = importlib.util.find_spec("h5py") is not None
    if have_h5py:
        write_lasy(path, ld)
    else:
        laser_file._CACHE[path] = ld
    text = gauss_text.replace(
        "laser1.profile = Gaussian",
        f"laser1.profile = from_file\nlaser1.lasy_file_name = {path}")
    records = []
    orig = laser_mod.fill_amplitude

    def recorded(laser, ndim, Xp, Yp, t):
        amp = orig(laser, ndim, Xp, Yp, t)
        records.append((Xp.detach().clone(), float(t), amp.detach().clone()))
        return amp

    try:
        sim = warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(text), dtype=torch.float32, device=dev)
        if sim.cfg.lasers[0].profile != "from_file" or dataclasses.replace(
                sim.cfg, lasers=gauss.lasers) != gauss:
            raise AssertionError("main_lwfa_lasy: the deck differs from "
                                 "main_lwfa_deck's but for the laser")
        laser_mod.fill_amplitude = recorded
        with timed_fn(bs_mod, "binned_push_deposit") as k1c_t, \
                timed_fn(bs_mod, "rebin") as rebin_t:
            launches, _, _, _ = run_lwfa_path(dev, smi, "main_lwfa_lasy",
                                              sim, LWFA_LASY_PLAN)
            k1c_ms, rebin_ms = k1c_t.ms(), rebin_t.ms()
    finally:
        laser_mod.fill_amplitude = orig
        laser_file._CACHE.pop(path, None)
        shutil.rmtree(tmp, ignore_errors=True)
    if len(records) != steps:
        raise AssertionError(f"main_lwfa_lasy: {len(records)} antenna "
                             f"updates in {steps} steps")
    err = peak = 0.0
    for Xp, t, amp in records:
        X64 = Xp.double()
        ref = orig(gauss.lasers[0], 2, X64, torch.zeros_like(X64), t)
        err = max(err, float((amp.double() - ref).abs().max()))
        peak = max(peak, float(ref.abs().max()))
    e_max = gauss.lasers[0].e_max
    if not (err <= LASY_TOL * e_max and err <= LASY_TOL_PEAK * peak
            and peak > 0):
        raise AssertionError(f"main_lwfa_lasy: the antenna's amplitude is "
                             f"{err} off the Gaussian's (e_max {e_max}, "
                             f"largest amplitude {peak})")
    emit("main_lwfa_lasy_antenna", ok=True, steps=steps, h5py=have_h5py,
         lasy_source="file" if have_h5py else "in_memory",
         envelope_shape=list(ld.data.shape), envelope_build_s=build_s,
         amplitude_max_abs_err=err, amplitude_err_of_e_max=err / e_max,
         amplitude_err_of_peak=err / peak, largest_amplitude=peak,
         tol_of_e_max=LASY_TOL, tol_of_peak=LASY_TOL_PEAK,
         fused_pic_moving_window_mixed_ms_each=[round(m, 3)
                                                for m in k1c_ms],
         fused_pic_moving_window_mixed_ms=sum(k1c_ms) / len(k1c_ms),
         rebins=len(rebin_ms), rebin_ms_each=[round(m, 3) for m in rebin_ms],
         ragged_expand_launches=launches["ragged_expand"],
         fused_pic_2d_launches=launches["fused_pic_2d"], nvidia_smi=smi)
    add_launches({"fused_pic_moving_window_mixed": k1c_row,
                  "ragged_expand": k3_row},
                 {"fused_pic_moving_window_mixed": launches["fused_pic_2d"],
                  "ragged_expand": launches["ragged_expand"]},
                 "main_lwfa_lasy")


SHAPE4_STEPS = 4


def phase_main_shape4(dev, smi, n=2048, steps=SHAPE4_STEPS):
    """uniform2d-2048-order4: main2d's plasma (2048^2, 2 x 2 a cell each,
    33.5 M particles) at particle_shape = 4, float32, per particle (both
    packages' binned gates refuse order 4): a warm step, ``steps`` - 2
    steps timed with CUDA events and each deposit's and gather's device ms,
    then the last step; the Esirkepov continuity residual of the order-4
    deposit on the last step's particles in float64 on the card,
    ((rho(x) - rho(x - v dt)) / dt + div J, over the largest |div J|; its
    7-wide window, at roundoff); finite fields, every particle alive, the
    weight conserved."""
    import warpx_tpu_torch
    from warpx_tpu_torch.core import step as step_mod
    from warpx_tpu_torch.ops.deposit import (deposit_current_esirkepov,
                                             deposit_rho)
    from warpx_tpu_torch.ops.push import inv_gamma

    cfg = dataclasses.replace(main2d_cfg(n, steps), particle_shape=4,
                              tiled_particles="auto")
    geom = cfg.geometry
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    if sim.binned:
        raise AssertionError("main_shape4 took the tile-binned step")
    sim.init()
    sim.evolve(1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    timed = steps - 2
    with timed_deposits() as dep, timed_fn(step_mod, "gather_eb") as gat:
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(timed + 1)]
        marks[0].record()
        for mark in marks[1:]:
            sim.evolve(1)
            mark.record()
        marks[-1].synchronize()
        ms_steps = [marks[i].elapsed_time(marks[i + 1])
                    for i in range(timed)]
        deposits = dep.report(timed)
        gather_ms = gat.ms()
    sim.evolve()
    torch.cuda.synchronize()
    peak_mem = torch.cuda.max_memory_allocated()
    # the continuity of the order-4 deposit, float64, on the last step's
    # particles
    j64 = [torch.zeros(geom.n_cell, dtype=torch.float64, device=dev)
           for _ in range(3)]
    rho_new = torch.zeros(geom.n_cell, dtype=torch.float64, device=dev)
    rho_old = torch.zeros_like(rho_new)
    for sp_cfg in cfg.species:
        sp = sim.state.species[sp_cfg.name]
        pos = [p.double() for p in sp.positions(2)]
        u = [a.double() for a in (sp.ux, sp.uy, sp.uz)]
        w = torch.where(sp.alive, sp.w.double(), 0.0)
        deposit_current_esirkepov(pos, *u, w, sp_cfg.charge, geom, cfg.dt, 4,
                                  chunk_size=cfg.deposit_chunk_size, out=j64)
        g = inv_gamma(*u)
        old = [pos[0] - cfg.dt * u[0] * g, pos[1] - cfg.dt * u[2] * g]
        rho_new = deposit_rho(pos, w, sp_cfg.charge, geom, 4, out=rho_new,
                              chunk_size=cfg.deposit_chunk_size)
        rho_old = deposit_rho(old, w, sp_cfg.charge, geom, 4, out=rho_old,
                              chunk_size=cfg.deposit_chunk_size)
    dx, dz = geom.dx
    div = ((j64[0] - torch.roll(j64[0], 1, 0)) / dx
           + (j64[2] - torch.roll(j64[2], 1, 1)) / dz)
    resid = float(((rho_new - rho_old) / cfg.dt + div).abs().max()
                  / div.abs().max())
    del j64, rho_new, rho_old, div
    sums = sim.checksums()
    alive = sum(int(sp.alive.sum()) for sp in sim.state.species.values())
    finite = all(bool(torch.isfinite(getattr(sim.state.fields, nm)).all())
                 for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy",
                            "jz"))
    total_w = cfg.species[0].density * geom.cell_volume * n * n
    w_rel = max(abs(sums[s.name]["particle_weight"] / total_w - 1)
                for s in cfg.species)
    if not (resid <= 1e-9 and finite and alive == 2 * 4 * n * n
            and w_rel <= 1e-5):
        raise AssertionError(f"main_shape4: residual {resid}, finite "
                             f"{finite}, {alive} alive, weight {w_rel}")
    ms_step = sum(ms_steps) / timed
    emit("main_shape4", ok=True, n_cell=geom.n_cell, order=4,
         path="per_particle", n_particles=alive, steps=sim.state.step,
         steps_timed=timed, ms_per_step=ms_step,
         ms_each_step=[round(m, 3) for m in ms_steps],
         pushes_per_s=alive / (ms_step * 1e-3), deposits=deposits,
         gather_ms_per_step=sum(gather_ms) / timed, gather_calls=len(
             gather_ms), continuity_residual=resid, continuity_tol=1e-9,
         weight_rel=w_rel, init_s=init_s, peak_memory_bytes=peak_mem,
         checksum_jz=sums["lev=0"]["jz"], device=torch.cuda.get_device_name(0),
         nvidia_smi=smi)


# ---- the electrostatic solvers, the hybrid solver, the medium and the NCI
# corrector (ROADMAP Queue A 11.3, first half) ------------------------------

EP0 = 8.8541878128e-12
MU0 = 1.25663706212e-06
M_P = 1.67262192369e-27
# the driven electrode of uniform-128-es: V0 sin(2 pi t / (40 dt)) on the
# upper z wall, the lower one grounded
ES_WALL_V0 = 100.0
ES_WALL_PERIOD = 40
ES_STEPS = 10
# the Poisson residual |L phi - rho/eps0| at interior nodes over max
# |rho/eps0|, float32: phi carries the 100 V wall potential to 2^-24 of
# itself, and L (12/dx^2 at the grid scale) amplifies that roundoff to
# ~1e-7 of the thermal plasma's rho/eps0 (~1e16 V/m^2); the DST-I / FFT
# pair adds ~1e-6 of its own
TOL_ES_RESIDUAL = 1e-4
# B = beta x E / c of the open-box beam, cell-centered, float32: the same
# differences of phi averaged in another order
TOL_ES_B = 1e-4
# tests/test_electrostatic.py's beam (the reference's open_bc_poisson_solver
# deck): sigma_x, sigma_y, sigma_z and its charge, on a +-4 sigma box
IGF_SIGMA = (516e-9, 7.7e-9, 300e-6)
IGF_Q = -3.2e-9
# 2^24 macro-particles: at 128^3 (16 cells a sigma along each axis) the
# shot noise of 2^20 moves E by 3-5 % off the Bassetti-Erskine field within
# one sigma_z of the center and 2^22 by up to 5.7 % at 2 sigma_z; 2^24 keeps
# it under 2.8 % there (float32, filter on, CPU runs of this repo)
IGF_NPART = 2 ** 24
IGF_STEPS = 3
# the JAX test's gate on the Bassetti-Erskine field
TOL_BASSETTI = 0.04
HYBRID_STEPS = 10
# div B of the hybrid run over B0/dx: each RK4 step adds a discrete curl,
# whose divergence is zero but for the rounding of B + dB, at most 6
# half-ulps of B0 over dx per update in float32 (3.6e-7); 2 x 10 substeps x
# 10 steps = 200 updates bound it linearly by 7.2e-5 (1.8e-5 was seen at 16^3
# on the CPU)
TOL_DIVB_HYBRID = 2e-4
NCI_DRIFT_STEPS = 600
NCI_RATIO = 30.0  # tests/test_nci.py's gate
LWFA_NCI_PLAN = dict(warm=6, timed=6, counted=2, interval=16)


def es_electrons(ndim, **kw):
    """A warm electron patch inside the 10 um box of ``es_box_cfg``."""
    from warpx_tpu_torch.core.config import SpeciesConfig

    base = dict(name="electrons", charge=-Q_E, mass=M_E,
                injection_style="nuniformpercell",
                num_particles_per_cell_each_dim=(1,) * ndim,
                profile="constant", density=1e22,
                momentum_distribution="gaussian", ux_th=1e-3, uy_th=1e-3,
                uz_th=1e-3, bounds_lo=(2e-6,) * ndim,
                bounds_hi=(6e-6, 7e-6, 6.5e-6)[:ndim])
    base.update(kw)
    return SpeciesConfig(**base)


def es_box_cfg(ndim, species, electrostatic="labframe", **kw):
    """A 16^ndim, 10 um box between PEC (Dirichlet) walls, absorbing
    particle boundaries, 3 steps of 1 fs (tests/test_torch_electrostatic.py
    ``_es_cfg``)."""
    from warpx_tpu_torch.core.config import SimConfig
    from warpx_tpu_torch.core.grid import Geometry

    base = dict(max_step=3, dt=1e-15, species=species,
                electrostatic=electrostatic, em_solver="none",
                field_bc_lo=("pec",) * ndim, field_bc_hi=("pec",) * ndim,
                particle_bc_lo=("absorbing",) * ndim,
                particle_bc_hi=("absorbing",) * ndim, use_filter=False,
                tiled_particles="off", current_deposition="direct")
    base.update(kw)
    periodic = tuple(bc == "periodic" for bc in base["field_bc_lo"])
    geom = Geometry(ndim=ndim, n_cell=(16,) * ndim, prob_lo=(0.0,) * ndim,
                    prob_hi=(1e-5,) * ndim, periodic=periodic)
    return SimConfig(geometry=geom, **base)


def magnetostatic_cfg():
    """tests/test_electrostatic.py::test_magnetostatic_sinusoidal_current:
    a z current J1 sin(kx) on a periodic 32 x 8 x 8 box."""
    from warpx_tpu_torch.core.config import SimConfig, SpeciesConfig
    from warpx_tpu_torch.core.grid import Geometry

    L = 8e-6
    geom = Geometry(ndim=3, n_cell=(32, 8, 8), prob_lo=(0.0,) * 3,
                    prob_hi=(L, L / 4, L / 4), periodic=(True,) * 3)
    sp = SpeciesConfig(
        name="electrons", charge=-Q_E, mass=M_E,
        injection_style="nuniformpercell",
        num_particles_per_cell_each_dim=(4, 1, 1),
        profile="parse_density_function",
        density_expr=f"1.0e24*(1+0.5*sin(2*pi*x/{L}))",
        momentum_distribution="constant", uz=0.1)
    return SimConfig(geometry=geom, max_step=3, dt=1e-18, species=(sp,),
                     electrostatic="labframe-electromagnetostatic",
                     tiled_particles="off")


def igf_beam_cfg(n=128, npart=IGF_NPART, uz=1000.0, steps=IGF_STEPS,
                 sigma=IGF_SIGMA, q_tot=IGF_Q):
    """beam-<n>-igf: the relativistic Gaussian beam of the reference's
    open_bc_poisson_solver deck on a +-4 sigma box with open faces,
    relativistic electrostatics through the integrated Green function
    (warpx.poisson_solver = fft), direct deposition, dt at the Yee limit
    of the cells (the JAX reader's choice), its bilinear filter on (the
    reference deck's default)."""
    from warpx_tpu_torch.core.config import SimConfig, SpeciesConfig
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    geom = Geometry(ndim=3, n_cell=(n,) * 3,
                    prob_lo=tuple(-4 * s for s in sigma),
                    prob_hi=tuple(4 * s for s in sigma),
                    periodic=(False,) * 3)
    beam = SpeciesConfig(
        name="electron", charge=-Q_E, mass=M_E,
        injection_style="gaussian_beam", x_rms=sigma[0], y_rms=sigma[1],
        z_rms=sigma[2], npart=npart, q_tot=q_tot,
        momentum_distribution="gaussian", uz=uz)
    return SimConfig(
        geometry=geom, max_step=steps, dt=compute_dt_yee(geom, 0.999),
        species=(beam,), electrostatic="relativistic", em_solver="none",
        poisson_solver="fft", field_bc_lo=("open",) * 3,
        field_bc_hi=("open",) * 3, particle_bc_lo=("absorbing",) * 3,
        particle_bc_hi=("absorbing",) * 3, use_filter=True,
        tiled_particles="off", current_deposition="direct")


def hybrid_cfg(ndim=3, n=128, ppc=2, steps=HYBRID_STEPS, substeps=10):
    """uniform-<n>-hybrid: protons at ppc^ndim a cell (n0 = 1e20 m^-3) in
    a periodic 1 m box with fluid electrons (Te = 10 eV), the guide field
    B0 = 0.25 T along z and a shear-Alfven perturbation By = 0.02 B0
    sin(2 pi z / L) (tests/test_hybrid.py::test_alfven_wave_frequency, in
    2D/3D), dt = 2e-3 of the ion gyro-period, direct deposition, per
    particle."""
    from warpx_tpu_torch.core.config import SimConfig, SpeciesConfig
    from warpx_tpu_torch.core.grid import Geometry

    L, B0, n0 = 1.0, 0.25, 1e20
    geom = Geometry(ndim=ndim, n_cell=(n,) * ndim, prob_lo=(0.0,) * ndim,
                    prob_hi=(L,) * ndim, periodic=(True,) * ndim)
    sp = SpeciesConfig(
        name="protons", charge=Q_E, mass=M_P,
        injection_style="nuniformpercell",
        num_particles_per_cell_each_dim=(ppc,) * ndim, profile="constant",
        density=n0, momentum_distribution="gaussian", ux_th=1e-5,
        uy_th=1e-5, uz_th=1e-5)
    wci = Q_E * B0 / M_P
    return SimConfig(
        geometry=geom, max_step=steps, dt=2e-3 * 2 * math.pi / wci,
        species=(sp,), em_solver="hybrid", current_deposition="direct",
        hybrid_elec_temp=10.0, hybrid_n0_ref=n0, hybrid_n_floor=n0 * 1e-3,
        hybrid_substeps=substeps, tiled_particles="off",
        b_ext_grid=("parse", ("0", f"{0.02 * B0}*sin(2*pi*z/{L})",
                              f"{B0}")))


def medium_cfg(n, steps, cfl=0.5, **kw):
    """A periodic n^3 box of 1 m in a macroscopic medium, dt at ``cfl`` of
    the vacuum Courant limit (half: tests/test_macroscopic.py's)."""
    from warpx_tpu_torch.core.config import SimConfig
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    geom = Geometry(ndim=3, n_cell=(n,) * 3, prob_lo=(0.0,) * 3,
                    prob_hi=(1.0,) * 3, periodic=(True,) * 3)
    return SimConfig(geometry=geom, max_step=steps,
                     dt=compute_dt_yee(geom, cfl),
                     em_solver_medium="macroscopic", use_filter=False,
                     tiled_particles="off", **kw)


def nci_drift_cfg(nci, steps):
    """tests/test_nci.py's cold gamma = 10 electron-ion plasma (ions of 5
    electron masses) drifting along z on a periodic 32^2 grid at 1e27
    m^-3, order 3, CFL 0.98, per particle in both runs."""
    from warpx_tpu_torch.core.config import SimConfig, SpeciesConfig
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    geom = Geometry(ndim=2, n_cell=(32, 32), prob_lo=(0.0, 0.0),
                    prob_hi=(16e-6, 16e-6), periodic=(True, True))
    uz = math.sqrt(10.0 ** 2 - 1.0)
    species = tuple(
        SpeciesConfig(name=nm, charge=q, mass=m,
                      injection_style="nuniformpercell",
                      num_particles_per_cell_each_dim=(2, 2),
                      profile="constant", density=1.0e27,
                      momentum_distribution="gaussian", uz=uz, ux_th=1e-3,
                      uy_th=1e-3, uz_th=1e-3)
        for nm, q, m in (("electrons", -Q_E, M_E), ("ions", Q_E, 5 * M_E)))
    return SimConfig(geometry=geom, max_step=steps,
                     dt=compute_dt_yee(geom, 0.98), particle_shape=3,
                     species=species, use_nci_corr=nci,
                     tiled_particles="off")


def grouped_agree(got, ref, tol, what):
    """``checksums_agree`` with each quantity held within ``tol`` of the
    largest of its group (E*, B*, j*, particle_momentum_*,
    particle_position_*): a component the physics leaves at roundoff (Ey
    of a current along z) compares at its group's scale."""
    def group_of(q):
        for pre in ("particle_momentum_", "particle_position_"):
            if q.startswith(pre):
                return pre
        return q[0] if len(q) == 2 and q[0] in "EBj" else q

    worst = 0.0
    for group in ref:
        if set(got[group]) != set(ref[group]):
            raise AssertionError(f"{what}: {group} holds "
                                 f"{sorted(got[group])}")
        scale = {}
        for q, a in ref[group].items():
            scale[group_of(q)] = max(scale.get(group_of(q), 0.0), abs(a))
        for q, a in ref[group].items():
            if q in ("divE", "divB"):
                continue
            s = scale[group_of(q)]
            r = abs(got[group][q] - a) / s if s else abs(got[group][q])
            worst = max(worst, r)
            if r > tol:
                raise AssertionError(f"{what} checksum {group}/{q}: "
                                     f"{got[group][q]!r} vs {a!r}")
    return worst


def es_parity_cases():
    """(name, SimConfig or deck text, steps, extra fields to compare)."""
    nci_deck = (LWFA_32X64_DECK.replace("max_step = 12", "max_step = 6")
                .replace("warpx.sort_intervals = 4",
                         "warpx.sort_intervals = 1")
                + "particles.use_fdtd_nci_corr = 1\n")
    two = (es_electrons(2, name="a", momentum_distribution="constant",
                        uz=3.0, ux_th=0.0, uy_th=0.0, uz_th=0.0),
           es_electrons(2, name="b", charge=Q_E, ux=0.5, uz=1.0))
    mixed = es_box_cfg(
        2, (es_electrons(2, bounds_lo=(), bounds_hi=()),),
        field_bc_lo=("periodic", "pec"), field_bc_hi=("periodic", "pec"),
        particle_bc_lo=("periodic", "absorbing"),
        particle_bc_hi=("periodic", "absorbing"),
        boundary_potentials=(("", ""), ("0", "50*sin(t*1e15)")))
    from warpx_tpu_torch.core.config import SpeciesConfig

    medium_sp = SpeciesConfig(
        name="electrons", charge=-Q_E, mass=M_E,
        injection_style="nuniformpercell",
        num_particles_per_cell_each_dim=(1, 1, 1), profile="constant",
        density=1e10, momentum_distribution="gaussian", ux_th=1e-2,
        uy_th=1e-2, uz_th=1e-2)
    return [
        ("labframe_walls", es_box_cfg(2, (es_electrons(2),),
                                      boundary_potentials=(
                                          ("0", "100*sin(t*1e14)"),
                                          ("5", "-3*t*1e15"))), ("phi",)),
        ("relativistic", es_box_cfg(2, two, "relativistic"), ("phi",)),
        ("magnetostatic", magnetostatic_cfg(), ("phi",)),
        ("open_igf", igf_beam_cfg(n=12, npart=3000, uz=50.0,
                                  sigma=(2e-6, 1.5e-6, 4e-6), q_tot=-1e-12),
         ("phi",)),
        ("mixed_walls", mixed, ("phi",)),
        ("hybrid", hybrid_cfg(ndim=2, n=16, ppc=2, steps=3, substeps=4),
         ("hrho", "hjx", "hjy", "hjz")),
        ("conductor", medium_cfg(8, 3, cfl=0.9, macro_sigma=5e-3,
                                 macro_epsilon=2 * EP0,
                                 macroscopic_sigma_method="laxwendroff",
                                 species=(medium_sp,)), ()),
        ("nci_periodic", nci_drift_cfg(True, 5), ()),
        ("nci_bounded", nci_deck + "tpu.tiled_particles = off\n", ()),
        ("nci_bounded_binned", nci_deck + "tpu.tiled_particles = on\n", ()),
    ]


def phase_es_parity(dev):
    """es_parity: the electrostatic solvers (lab frame with f(t) wall
    potentials, relativistic with two drifting species, magnetostatic, an
    open 12^3 box through the integrated Green function, a box periodic
    along x between Dirichlet z walls), a hybrid-PIC plasma (2D, 4 RK4
    substeps), a conducting dielectric with particles, and the NCI
    corrector on the periodic per-particle step and on the bounded 32 x 64
    laser-wakefield deck per particle and tile-binned (K1c), each in
    float64 on the card against the CPU: every checksum within 1e-9 of its
    group's scale, and phi or the hybrid temporaries within 1e-9."""
    import warpx_tpu_torch
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.utils.parser import Deck

    cases = {}
    k1c_before = fp.binned_push_deposit.launches_2d
    for name, made, fields in es_parity_cases():
        sims = {}
        for device in (dev, "cpu"):
            if isinstance(made, str):
                sim = warpx_tpu_torch.Simulation.from_deck(
                    Deck.from_string(made), dtype=torch.float64,
                    device=device)
            else:
                sim = warpx_tpu_torch.Simulation(made, dtype=torch.float64,
                                                 device=device)
            sim.init()
            sim.evolve()
            sims[str(device)] = sim
        card, cpu = sims[str(dev)], sims["cpu"]
        if name == "nci_bounded_binned" and not card.binned:
            raise AssertionError("es_parity: the binned NCI deck went per "
                                 "particle")
        worst = grouped_agree(card.checksums(), cpu.checksums(), 1e-9,
                              f"es_parity {name}")
        field_err = {}
        for nm in fields:
            field_err[nm] = rel_err(getattr(card.state.fields, nm).cpu(),
                                    getattr(cpu.state.fields, nm))[1]
            if field_err[nm] > 1e-9:
                raise AssertionError(f"es_parity {name}: {nm} differs by "
                                     f"{field_err[nm]}")
        cases[name] = {"max_rel_err": worst, "fields_rel_err": field_err,
                       "steps": card.state.step}
    emit("es_parity", ok=True, tol=1e-9, cases=cases,
         k1c_launches=fp.binned_push_deposit.launches_2d - k1c_before)


def es_main_cfg(n=128, steps=ES_STEPS):
    """uniform-128-es: main_cfg's plasma (electrons and ions of the
    electron's mass, 2 a cell each, 8.39 M at n = 128) and dt under the
    lab-frame electrostatic solver, periodic along x and y, between
    Dirichlet z walls (potential 0 below, ES_WALL_V0 sin(2 pi t /
    (ES_WALL_PERIOD dt)) above) that absorb particles, per particle."""
    cfg = main_cfg(n, steps)
    dt = cfg.dt
    wall = f"{ES_WALL_V0}*sin(2*pi*t/({ES_WALL_PERIOD * dt!r}))"
    return dataclasses.replace(
        cfg, geometry=dataclasses.replace(cfg.geometry,
                                          periodic=(True, True, False)),
        electrostatic="labframe", em_solver="none",
        current_deposition="direct", tiled_particles="off",
        field_bc_lo=("periodic", "periodic", "pec"),
        field_bc_hi=("periodic", "periodic", "pec"),
        particle_bc_lo=("periodic", "periodic", "absorbing"),
        particle_bc_hi=("periodic", "periodic", "absorbing"),
        boundary_potentials=(("", ""), ("", ""), ("0", wall)))


def drive_steps(sim, timed):
    """Init, one warm step, ``timed`` steps with an event after each,
    PROFILED_STEPS_PER_PARTICLE profiled steps, the rest to max_step:
    (init_s, ms a
    step, each step's ms, the profile)."""
    t0 = time.perf_counter()
    sim.init()
    sim.evolve(1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
    marks[0].record()
    for mark in marks[1:]:
        sim.evolve(1)
        mark.record()
    marks[-1].synchronize()
    series = [round(a.elapsed_time(b), 3) for a, b in zip(marks, marks[1:])]
    breakdown = profile_steps(sim, PROFILED_STEPS_PER_PARTICLE)
    sim.evolve()
    torch.cuda.synchronize()
    return init_s, sum(series) / timed, series, breakdown


def profile_call(fn):
    """(device ms, kernel launches, wall ms) of one call of ``fn`` under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_us, launches = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        dev_us += us
        launches += evt.count
    return dev_us / 1e3, launches, wall


def phase_main_es(dev, smi, n=128):
    """uniform-128-es (``es_main_cfg``), float32, ES_STEPS steps: a warm
    step, 5 timed, PROFILED_STEPS_PER_PARTICLE profiled, the last.  On the
    final state:
    the discrete Poisson residual |L phi - rho/eps0| at the interior nodes
    over max |rho/eps0| (float64 from the stored phi) within
    TOL_ES_RESIDUAL, the lower wall's phi zero and the upper one's equal
    to V(t) rounded to float32 after every solve (the initial one and each
    step's), E equal to -grad(phi) of the stored phi bitwise; the space-charge solve (deposit, Poisson solve, E) and the
    Poisson solve alone timed."""
    import warpx_tpu_torch
    from warpx_tpu_torch.core.bounded_step import BoundedStepper
    from warpx_tpu_torch.diagnostics.fields import deposit_total_rho
    from warpx_tpu_torch.solvers.electrostatic import phi_to_e

    cfg = es_main_cfg(n)
    torch.cuda.reset_peak_memory_stats()
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    if not sim.is_bounded or sim.binned:
        raise AssertionError("main_es: not the bounded per-particle step")
    n0 = 2 * 2 * n ** 3
    walls = []
    solve = BoundedStepper.solve_es

    def recorded(self, state):
        out = solve(self, state)
        walls.append((float(state.time), out.fields.phi[0, 0, -1]))
        return out

    BoundedStepper.solve_es = recorded
    try:
        init_s, ms_step, series, breakdown = drive_steps(sim, 5)
    finally:
        BoundedStepper.solve_es = solve
    # every solve's upper wall against V(t) rounded to float32
    wall_vals = [(t, float(v)) for t, v in walls]
    wall_ok = len(wall_vals) == cfg.max_step + 1 and all(
        v == float(np.float32(ES_WALL_V0 * math.sin(
            2 * math.pi * t / (ES_WALL_PERIOD * cfg.dt))))
        for t, v in wall_vals)
    state = sim.state
    f = state.fields
    geom = cfg.geometry
    periodic = (True, True, False)
    ((_, _, _, solver),) = sim.stepper.es_groups
    rho = deposit_total_rho(state, cfg)
    op = solver.apply_op(f.phi.double()) * EP0
    inner = (slice(None), slice(None), slice(1, -1))
    resid = float((op[inner] - rho.double()[inner]).abs().max()
                  / rho.double()[inner].abs().max())
    wall_ok = wall_ok and bool((f.phi[:, :, -1] == wall_vals[-1][1]).all()
                               ) and not bool(f.phi[:, :, 0].any())
    e_ok = all(torch.equal(e, getattr(f, nm)) for nm, e in zip(
        ("Ex", "Ey", "Ez"), phi_to_e(f.phi, geom, periodic)))
    alive = sum(int(sp.alive.sum()) for sp in state.species.values())
    finite = all(bool(torch.isfinite(getattr(f, nm)).all())
                 for nm in ("Ex", "Ey", "Ez", "phi"))
    if not (resid <= TOL_ES_RESIDUAL and wall_ok and e_ok and finite
            and 0.99 * n0 <= alive <= n0):
        raise AssertionError(f"main_es: residual {resid}, wall {wall_ok}, "
                             f"E = -grad phi {e_ok}, finite {finite}, "
                             f"{alive} alive of {n0}")
    solve_ms = cuda_ms(lambda: sim.stepper.solve_es(state), 3)
    phi_b = sim.stepper.wall_potential(state.time)
    poisson_ms = cuda_ms(lambda: solver.solve(rho, phi_b), 5)
    rho_ms = cuda_ms(lambda: deposit_total_rho(state, cfg), 3)
    emit("main_es", ok=True, n_cell=geom.n_cell, n_particles=n0,
         alive_at_end=alive, absorbed=n0 - alive, steps=state.step,
         steps_timed=5, ms_per_step=ms_step, ms_each_step=series,
         pushes_per_s=alive / (ms_step * 1e-3), init_s=init_s,
         device_busy_share=breakdown["device_busy_share"],
         solve_es_ms=solve_ms, poisson_solve_ms=poisson_ms,
         rho_deposit_ms=rho_ms, poisson_residual=resid,
         poisson_residual_tol=TOL_ES_RESIDUAL,
         wall_potential_V=[v for _, v in wall_vals], wall_equal=wall_ok, e_equals_minus_grad_phi=e_ok,
         phi_max_abs=float(f.phi.abs().max()),
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    emit("main_es_profile", steps=PROFILED_STEPS_PER_PARTICLE, **breakdown)


def bassetti_erskine(x, y, z, sigma=IGF_SIGMA, q=IGF_Q):
    """(Ex, Ey) of the Gaussian beam, tests/test_electrostatic.py's
    ``evaluate_E``."""
    from scipy.special import erf

    sx, sy, sz = sigma

    def w(zz):
        return np.exp(-zz ** 2) * (1 + erf(1.0j * zz))

    den = np.sqrt(2 * (sx ** 2 - sy ** 2))
    term1 = w((x + 1j * y) / den)
    arg2 = (x * sy / sx + 1j * y * sx / sy) / den
    term2 = -np.exp(-x ** 2 / (2 * sx ** 2) - y ** 2 / (2 * sy ** 2)) * w(arg2)
    factor = (q / (2.0 * np.sqrt(2.0) * math.pi * EP0 * sz * den)
              * np.exp(-z ** 2 / (2 * sz ** 2)))
    E = factor * (term1 + term2)
    return E.imag, E.real


def phase_main_es_open(dev, smi, n=128):
    """beam-128-igf (``igf_beam_cfg``): 2^24 electrons at u_z = 1000,
    relativistic, the open 3D box through the integrated Green function
    (its transforms at (2 n + 2)^3), float32, IGF_STEPS steps.  The initial
    field against the Bassetti-Erskine field within TOL_BASSETTI of each
    line's largest value, on the JAX test's mask (|E| above 5 % of that
    largest value, two cells off the walls), along x and along y at the
    slices within 2 sigma_z of the center (the slices further out hold
    fewer macro-particles, and their shot noise passes the gate); B =
    beta x E / c
    within TOL_ES_B; the Green function's build, the IGF solve alone and
    ms a step."""
    import warpx_tpu_torch
    from warpx_tpu_torch.diagnostics.fields import (cell_centered_output,
                                                    deposit_total_rho)
    from warpx_tpu_torch.solvers.electrostatic import (igf_greens_hat,
                                                       solve_open_igf)

    cfg = igf_beam_cfg(n)
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    sim.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ((_, beta3, _, g_hat),) = sim.stepper.es_groups
    out = {k: v.double().cpu().numpy() for k, v in cell_centered_output(
        sim.state, cfg, sim.staggering,
        names=["Ex", "Ey", "Bx", "By"]).items()}
    sx, sy, sz = IGF_SIGMA
    gx, gy, gz = [(np.arange(n) + 0.5) / n * 8 * s - 4 * s
                  for s in IGF_SIGMA]
    interior = np.zeros(n, bool)
    interior[2:-2] = True
    worst = {"Ex": 0.0, "Ey": 0.0}
    slices = [k for k in range(n // 16, n, n // 16) if abs(gz[k]) <= 2 * sz]
    for k in slices:
        for nm, line, th in (
                ("Ex", out["Ex"][:, n // 2, k],
                 bassetti_erskine(gx, 0.0, gz[k])[0]),
                ("Ey", out["Ey"][n // 2, :, k],
                 bassetti_erskine(0.0, gy, gz[k])[1])):
            m = (np.abs(th) > 0.05 * np.abs(th).max()) & interior
            worst[nm] = max(worst[nm], float(
                np.abs(line - th)[m].max() / np.abs(th).max()))
    beta = beta3[2]
    e_scale = beta * max(np.abs(out["Ex"]).max(),
                         np.abs(out["Ey"]).max()) / C_LIGHT
    b_err = max(np.abs(out["By"] - beta * out["Ex"] / C_LIGHT).max(),
                np.abs(out["Bx"] + beta * out["Ey"] / C_LIGHT).max()) / e_scale
    b_max = float(np.abs(out["By"]).max())
    if not (max(worst.values()) <= TOL_BASSETTI and b_err <= TOL_ES_B
            and b_max > 0):
        raise AssertionError(f"main_es_open: Bassetti-Erskine {worst}, "
                             f"B = beta x E / c {b_err}, max|By| {b_max}")
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(IGF_STEPS + 1)]
    marks[0].record()
    for mark in marks[1:]:
        sim.evolve(1)
        mark.record()
    marks[-1].synchronize()
    series = [round(a.elapsed_time(b), 3) for a, b in zip(marks, marks[1:])]
    state = sim.state
    alive = int(state.species["electron"].alive.sum())
    rho = deposit_total_rho(state, cfg)
    igf_ms = cuda_ms(lambda: solve_open_igf(rho, g_hat), 5)
    solve_ms = cuda_ms(lambda: sim.stepper.solve_es(state), 3)
    beta_act = sim.stepper.es_groups[0][2]
    cell = tuple(d / math.sqrt(1.0 - b ** 2)
                 for d, b in zip(cfg.geometry.dx, beta_act))
    t1 = time.perf_counter()
    igf_greens_hat(sim.stepper.shapes["rho"], cell, torch.float32, dev)
    torch.cuda.synchronize()
    green_s = time.perf_counter() - t1
    emit("main_es_open", ok=True, n_cell=cfg.geometry.n_cell,
         n_particles=cfg.species[0].npart, alive_at_end=alive,
         transform_shape=[2 * s for s in sim.stepper.shapes["rho"]],
         init_s=init_s, green_function_build_s=green_s,
         igf_solve_ms=igf_ms, solve_es_ms=solve_ms,
         ms_per_step=sum(series) / IGF_STEPS, ms_each_step=series,
         bassetti_erskine_rel_err=worst, bassetti_tol=TOL_BASSETTI,
         slices=slices, b_equals_beta_cross_e_rel_err=b_err,
         b_tol=TOL_ES_B, beta=beta, max_abs_By=b_max,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)


def phase_main_hybrid(dev, smi, n=128):
    """uniform-128-hybrid (``hybrid_cfg``): 16.8 M protons, 10 RK4
    substeps per half step, float32, driven by run_per_particle_path (a
    warm step, 4 timed, PROFILED_STEPS_PER_PARTICLE profiled, one with its
    deposits
    timed, the last); then div B over B0/dx within TOL_DIVB_HYBRID, and the
    field advance of one step alone: its device ms, kernel launches and
    wall ms."""
    from warpx_tpu_torch.core.grid import yee_staggering
    from warpx_tpu_torch.solvers import hybrid as hyb
    from warpx_tpu_torch.solvers import yee

    cfg = hybrid_cfg(3, n)
    sim = run_per_particle_path(dev, smi, "main_hybrid", cfg, 8 * n ** 3, 4)
    f = sim.state.fields
    geom = cfg.geometry
    div_b = float(yee.compute_div_b(f, geom).abs().max())
    b0_dx = 0.25 / min(geom.dx)
    if not div_b <= TOL_DIVB_HYBRID * b0_dx:
        raise AssertionError(f"main_hybrid: max|div B| {div_b} against "
                             f"B0/dx {b0_dx}")
    stag = yee_staggering(3)
    eta = hyb.resistivity(cfg)
    j3 = (f.hjx, f.hjy, f.hjz)

    def advance():
        return hyb.hybrid_evolve_fields(f, f.hrho, f.hrho, j3, j3, geom,
                                        stag, cfg, eta, cfg.dt)

    advance()
    dev_ms, launches, wall_ms = profile_call(advance)
    emit("main_hybrid_fields", ok=True, substeps=cfg.hybrid_substeps,
         rk4_stages=2 * cfg.hybrid_substeps * 4,
         field_advance_device_ms=dev_ms, field_advance_launches=launches,
         field_advance_wall_ms=wall_ms,
         field_advance_event_ms=cuda_ms(advance, 2),
         max_abs_div_b=div_b, b0_over_dx=b0_dx,
         div_b_over_b0_dx=div_b / b0_dx, tol=TOL_DIVB_HYBRID,
         max_abs_Ey=float(f.Ey.abs().max()), nvidia_smi=smi)


def phase_main_macroscopic(dev, smi, n=128, steps=20):
    """dielectric-128: tests/test_macroscopic.py's standing wave (mode 2
    along z) in eps = 4 eps0 at n^3 periodic cells, float64, ``steps``
    steps: omega from the three-term recurrence of the mode's samples
    against the Yee dispersion in the dielectric (1e-9) and against
    k c / 2 (5e-3); then the uniform conductor (sigma = 5e-3, backward
    Euler) damping a uniform Ex as alpha^n (1e-12)."""
    import warpx_tpu_torch

    cfg = medium_cfg(n, steps, macro_epsilon=4.0 * EP0)
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device=dev)
    if sim.binned or sim.medium is None:
        raise AssertionError("main_macroscopic: not the medium's step")
    sim.init()
    m = 2
    k = 2 * math.pi * m
    z = torch.arange(n, dtype=torch.float64, device=dev) / n
    ex = torch.cos(k * z).expand(n, n, n).contiguous()
    state = sim.state.replace(fields=sim.state.fields.replace(Ex=ex))
    samples = []
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(steps):
        samples.append(torch.fft.fft(state.fields.Ex[0, 0])[m].real)
        state = sim.step(state)
    b.record()
    b.synchronize()
    ms_step = a.elapsed_time(b) / steps
    s = torch.stack(samples).cpu().numpy()
    dt = cfg.dt
    w_meas = math.acos(float(np.median((s[2:] + s[:-2]) / (2 * s[1:-1])))) / dt
    v = C_LIGHT / 2.0
    dz = 1.0 / n
    w_yee = 2.0 / dt * math.asin(v * dt / dz * math.sin(k * dz / 2.0))
    err_yee = abs(w_meas - w_yee) / w_yee
    err_kv = abs(w_meas - k * v) / (k * v)
    sigma = 5e-3
    cond = medium_cfg(n, steps, macro_sigma=sigma)
    csim = warpx_tpu_torch.Simulation(cond, dtype=torch.float64, device=dev)
    csim.init()
    cstate = csim.state.replace(fields=csim.state.fields.replace(
        Ex=torch.ones_like(csim.state.fields.Ex)))
    for _ in range(steps):
        cstate = csim.step(cstate)
    alpha = (1.0 / (1.0 + sigma * cond.dt / EP0)) ** steps
    mean = float(cstate.fields.Ex.mean())
    std = float(cstate.fields.Ex.std())
    damp_err = abs(mean - alpha) / alpha
    if not (err_yee < 1e-9 and err_kv < 5e-3 and damp_err < 1e-12
            and std < 1e-12):
        raise AssertionError(f"main_macroscopic: omega against Yee "
                             f"{err_yee}, against k c/2 {err_kv}, damping "
                             f"{damp_err} (std {std})")
    emit("main_macroscopic", ok=True, n_cell=cfg.geometry.n_cell,
         eps_r=4.0, steps=steps, ms_per_step=ms_step, omega=w_meas,
         omega_yee=w_yee, rel_err_yee=err_yee, tol_yee=1e-9,
         rel_err_kc2=err_kv, tol_kc2=5e-3, conductor_alpha_n=alpha,
         conductor_mean=mean, conductor_rel_err=damp_err, tol_damp=1e-12,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)


def plasma_field_energy(sim):
    """The electromagnetic energy [J] of the cells that hold plasma
    (cell-centered rho non-zero), in float64."""
    from warpx_tpu_torch.diagnostics.fields import cell_centered_output

    out = cell_centered_output(sim.state, sim.cfg, sim.staggering,
                               names=["Ex", "Ey", "Ez", "Bx", "By", "Bz",
                                      "rho"])
    mask = out["rho"] != 0
    e2 = sum(out[nm].double()[mask].pow(2).sum() for nm in ("Ex", "Ey", "Ez"))
    b2 = sum(out[nm].double()[mask].pow(2).sum() for nm in ("Bx", "By", "Bz"))
    return (float((0.5 * EP0 * e2 + 0.5 * b2 / MU0)
                  * sim.cfg.geometry.cell_volume), int(mask.sum()))


def phase_main_lwfa_boosted_nci(dev, smi, k1c_row, k3_row, boosted_ms,
                                nx=2048, nz=8192):
    """lwfa2d-2048x8192-boosted-nci: ``lwfa_boosted_deck_text`` with
    particles.use_fdtd_nci_corr = 1 and nothing else changed, 20 steps
    through K1c and K3 driven as main_lwfa is (``run_lwfa_path``), K1c's
    device ms a launch; the corrector alone on the final padded fields;
    then the same 20 steps without the corrector from the same initial
    state, and the plasma region's field energy at the end of each.  Adds
    this path's launches to K1c's ('mixed') and K3's rows."""
    import copy

    import warpx_tpu_torch
    from warpx_tpu_torch.core import bounded_step as bs_mod
    from warpx_tpu_torch.core.step import _apply_nci
    from warpx_tpu_torch.utils.parser import Deck

    steps = lwfa_steps(LWFA_NCI_PLAN)
    text = (lwfa_boosted_deck_text(nx, nz, steps)
            + "particles.use_fdtd_nci_corr = 1\n")
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float32, device=dev)
    if not (sim.cfg.use_nci_corr and sim.cfg.gamma_boost == GAMMA_BOOST):
        raise AssertionError("main_lwfa_boosted_nci: not a boosted NCI run")
    start = []
    with timed_fn(bs_mod, "binned_push_deposit") as k1c_t, \
            timed_fn(bs_mod, "_apply_nci") as nci_t:
        launches, _, _, waits = run_lwfa_path(
            dev, smi, "main_lwfa_boosted_nci", sim, LWFA_NCI_PLAN,
            boosted=True, on_init=lambda s: start.append(
                copy.deepcopy(s.state)))
        k1c_ms, nci_ms = k1c_t.ms(), nci_t.ms()
    if len(nci_ms) != steps:
        raise AssertionError(f"main_lwfa_boosted_nci: the corrector ran "
                             f"{len(nci_ms)} times in {steps} steps")
    e_nci, cells = plasma_field_energy(sim)
    farr = sim.stepper._padded_eb(sim.state.fields)
    corrector_ms = cuda_ms(lambda: _apply_nci(farr, sim.cfg), 5)
    del farr
    # the same run without the corrector, from the same initial state
    plain = dataclasses.replace(sim.cfg, use_nci_corr=False)
    sim.cfg = sim.stepper.cfg = plain
    sim.state = start.pop()
    sim.is_synchronized = True
    sim.evolve()
    torch.cuda.synchronize()
    e_plain, cells_plain = plasma_field_energy(sim)
    if not (np.isfinite(e_nci) and np.isfinite(e_plain) and e_nci > 0):
        raise AssertionError(f"main_lwfa_boosted_nci: field energies "
                             f"{e_nci}, {e_plain}")
    emit("main_lwfa_boosted_nci_corrector", ok=True, steps=steps,
         ms_per_step=waits["ms_per_step"],
         main_lwfa_boosted_ms_per_step=boosted_ms,
         ms_per_step_over_boosted=(waits["ms_per_step"] / boosted_ms
                                   if boosted_ms else None),
         fused_pic_moving_window_mixed_ms=sum(k1c_ms) / len(k1c_ms),
         fused_pic_moving_window_mixed_ms_each=[round(m, 3)
                                                for m in k1c_ms],
         corrector_device_ms=corrector_ms,
         corrector_in_step_ms=sum(nci_ms) / len(nci_ms),
         plasma_field_energy_J={"with_corrector": e_nci,
                                "without_corrector": e_plain},
         energy_ratio_without_over_with=e_plain / e_nci,
         plasma_cells={"with_corrector": cells,
                       "without_corrector": cells_plain},
         ragged_expand_launches=launches["ragged_expand"],
         fused_pic_2d_launches=launches["fused_pic_2d"], nvidia_smi=smi)
    add_launches({"fused_pic_moving_window_mixed": k1c_row,
                  "ragged_expand": k3_row},
                 {"fused_pic_moving_window_mixed": launches["fused_pic_2d"],
                  "ragged_expand": launches["ragged_expand"]},
                 "main_lwfa_boosted_nci")


def state_tensors(state):
    """Every tensor of a periodic state, in a fixed order."""
    from warpx_tpu_torch.core.state import field_names

    out = [getattr(state.fields, nm) for nm in field_names(state.fields)]
    for sp in state.species.values():
        out += [getattr(sp, k) for k in ("w", "ux", "uy", "uz", "alive", "x",
                                         "y", "z") if getattr(sp, k) is not None]
        out += list(sp.extra.values())
    return out


def graph_evolve(sim, steps):
    """Advance the periodic per-particle ``sim`` (initialised,
    synchronized) by ``steps`` steps as ``Simulation.evolve`` does on the
    periodic domain: the -dt/2 momentum push, the steps, the +dt/2 push;
    the steps replayed from one captured CUDA graph of ``sim.step`` (at 32^2
    the step is ~12,500 small kernels, whose eager dispatch holds the card
    idle).  Returns (the eager step's ms, a replayed step's ms, whether
    the first replayed step's particles equal an eager step's from the same
    state bitwise, and the largest difference of its fields from that
    step's over each field's largest value: the float32 atomics of the
    deposits sum in another order, and J is the small residual of two
    species drifting together)."""
    from warpx_tpu_torch.core.state import field_names

    dt = sim.cfg.dt
    sim.state = sim._half_push(-0.5 * dt)
    sim.is_synchronized = False
    static = sim.state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = sim.step(static)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            sim.step(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sim.step(static)
        for a, b in zip(state_tensors(static), state_tensors(out)):
            a.copy_(b)
    graph.replay()
    pairs = list(zip(state_tensors(static), state_tensors(eager)))
    n_fields = len(field_names(static.fields))
    same = all(torch.equal(a, b) for a, b in pairs[n_fields:])
    diff = max(float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)
               for a, b in pairs[:n_fields])
    marks = (torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))
    marks[0].record()
    for _ in range(steps - 1):
        graph.replay()
    marks[1].record()
    marks[1].synchronize()
    replay_ms = marks[0].elapsed_time(marks[1]) / max(steps - 1, 1)
    sim.state = static.replace(step=static.step + steps,
                               time=static.time + steps * dt)
    sim.state = sim._half_push(0.5 * dt)
    sim.is_synchronized = True
    return eager_ms, replay_ms, same, diff


def phase_nci_drift(dev, smi, steps=NCI_DRIFT_STEPS):
    """nci_drift: tests/test_nci.py's drifting plasma (``nci_drift_cfg``),
    ``steps`` steps per particle in float32 (``graph_evolve``), with and
    without the corrector: the energy without it above NCI_RATIO times
    the energy with it; each first replayed step's particles equal to an
    eager step's from the same state."""
    import warpx_tpu_torch

    energies, ms, diffs, same = {}, {}, {}, {}
    for nci in (False, True):
        cfg = nci_drift_cfg(nci, steps)
        sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32,
                                         device=dev)
        if sim.binned:
            raise AssertionError("nci_drift took the tile-binned step")
        sim.init()
        eager_ms, replay_ms, same[nci], diffs[nci] = graph_evolve(sim,
                                                                  steps)
        ms[nci] = {"eager": eager_ms, "replayed": replay_ms}
        energies[nci] = field_energy(sim.state.fields, cfg.geometry)
    ratio = energies[False] / energies[True]
    if not (ratio > NCI_RATIO and all(same.values())):
        raise AssertionError(f"nci_drift: energy without the corrector "
                             f"{energies[False]}, with {energies[True]}; "
                             f"replayed particles as eager {same}")
    emit("nci_drift", ok=True, steps=steps,
         energy_J={"without_corrector": energies[False],
                   "with_corrector": energies[True]},
         ratio=ratio, gate=NCI_RATIO,
         ms_per_step={"without_corrector": ms[False],
                      "with_corrector": ms[True]},
         replayed_particles_equal_eager={"without_corrector": same[False],
                                         "with_corrector": same[True]},
         replayed_fields_vs_eager={"without_corrector": diffs[False],
                                   "with_corrector": diffs[True]},
         nvidia_smi=smi)


# ---- Queue A 11.3, second half: implicit solvers, fluids, embedded
# boundaries ----------------------------------------------------------------

def implicit_deck(dims, n, steps, scheme="theta_implicit_em", extra="",
                  ppc=1):
    """A periodic box of 16 um per axis with electrons and protons of
    parsed (sinusoidal) momenta, no filter, cfl 0.5, under an implicit
    scheme: the CPU tests' deck at ``n`` cells an axis."""
    span = 8e-6
    return f"""
max_step = {steps}
amr.n_cell = {f"{n} " * dims}
geometry.dims = {dims}
geometry.prob_lo = {f"{-span!r} " * dims}
geometry.prob_hi = {f"{span!r} " * dims}
warpx.use_filter = 0
warpx.cfl = 0.5
algo.evolve_scheme = {scheme}
picard.relative_tolerance = 1.e-11
picard.max_iterations = 60
my_constants.pi = 3.141592653589793
particles.species_names = electrons ions
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = {f"{ppc} " * dims}
electrons.profile = constant
electrons.density = 2.e19
electrons.momentum_distribution_type = parse_momentum_function
electrons.momentum_function_ux(x,y,z) = "0.2*sin(2*pi*x/16.e-6)"
electrons.momentum_function_uy(x,y,z) = "0.1*cos(2*pi*z/16.e-6)"
electrons.momentum_function_uz(x,y,z) = "0.15*sin(2*pi*z/16.e-6)"
ions.species_type = proton
ions.injection_style = NUniformPerCell
ions.num_particles_per_cell_each_dim = {f"{ppc} " * dims}
ions.profile = constant
ions.density = 2.e19
ions.momentum_distribution_type = parse_momentum_function
ions.momentum_function_ux(x,y,z) = "-0.004*cos(2*pi*x/16.e-6)"
ions.momentum_function_uy(x,y,z) = "0.002"
ions.momentum_function_uz(x,y,z) = "0.003*cos(2*pi*z/16.e-6)+0.001"
{extra}
"""


NEWTON_KEYS = """
implicit_evolve.nonlinear_solver = newton
implicit_evolve.max_particle_iterations = 3
newton.relative_tolerance = 1.e-12
gmres.relative_tolerance = 1.e-10
gmres.restart_length = 12
gmres.max_iterations = 48
"""


def fluid_langmuir_deck(dims, n, steps):
    """A cold-fluid Langmuir wave (density and velocity perturbed along x)
    on a periodic box of 20 um per axis, Esirkepov, no filter."""
    return f"""
max_step = {steps}
amr.n_cell = {f"{n} " * dims}
geometry.dims = {dims}
geometry.prob_lo = {"-10.e-6 " * dims}
geometry.prob_hi = {"10.e-6 " * dims}
warpx.cfl = 0.8
warpx.use_filter = 0
my_constants.pi = 3.141592653589793
my_constants.k0 = 2*pi/20.e-6
fluids.species_names = electrons
electrons.charge = -q_e
electrons.mass = m_e
electrons.profile = parse_density_function
electrons.density_function(x,y,z) = "2.e24*(1 + 0.01*cos(k0*x))"
electrons.momentum_distribution_type = parse_momentum_function
electrons.momentum_function_ux(x,y,z) = "0.01*sin(k0*x)"
electrons.momentum_function_uy(x,y,z) = "0.002*cos(k0*z)"
electrons.momentum_function_uz(x,y,z) = "0.005*sin(k0*z)"
"""


# the reference's rotated-cube TM eigenmodes
# (Examples/Tests/embedded_boundary_rotated_cube; the JAX package's
# tests/test_ect.py:64-131): a PEC cube of side 1 (2D: 1.06) turned by
# theta inside a [-0.8, 0.8] box, the mode laid on the grid at t = 0
ECT_CUBE = {
    3: ("yy=y*cos(-theta)-z*sin(-theta); zz=y*sin(-theta)+z*cos(-theta); "
        "max(max(max(x-0.5,-(x+0.5)),max(yy-0.5,-(yy+0.5))),"
        "max(zz-0.5,-(zz+0.5)))"),
    2: ("xx = x*cos(-theta) + z*sin(-theta); zz = -x*sin(-theta) + "
        "z*cos(-theta); max(max(xx-0.53,-(xx+0.53)), "
        "max(zz-0.53,-(zz+0.53)))"),
}
ECT_THETA = {3: math.pi / 6, 2: math.pi / 8}
ECT_B = {
    3: ("0",
        "-2/h2*mu0*(pi)*(pi)*sin(pi*(y*cos(-theta)-z*sin(-theta)-0.5))"
        "*cos(pi*(y*sin(-theta)+z*cos(-theta)-0.5))*cos(theta)"
        " - mu0*cos(pi*(y*cos(-theta)-z*sin(-theta)-0.5))"
        "*sin(pi*(y*sin(-theta)+z*cos(-theta)-0.5))*sin(theta)",
        "-2/h2*mu0*(pi)*(pi)*sin(pi*(y*cos(-theta)-z*sin(-theta)-0.5))"
        "*cos(pi*(y*sin(-theta)+z*cos(-theta)-0.5))*sin(theta)"
        " + mu0*cos(pi*(y*cos(-theta)-z*sin(-theta)-0.5))"
        "*sin(pi*(y*sin(-theta)+z*cos(-theta)-0.5))*cos(theta)"),
    2: ("0",
        "mu0*cos(pi/1.06*(-x*sin(-theta)+z*cos(-theta)-0.53))",
        "0"),
}


def ect_cube_deck(ndim, n, steps, solver="ect"):
    """The rotated-cube deck at n cells an axis (cfl 1, PEC walls)."""
    bx, by, bz = ECT_B[ndim]
    return f"""
max_step = {steps}
amr.n_cell = {f"{n} " * ndim}
geometry.dims = {ndim}
geometry.prob_lo = {"-0.8 " * ndim}
geometry.prob_hi = {"0.8 " * ndim}
warpx.cfl = 1
warpx.use_filter = 0
boundary.field_lo = {"pec " * ndim}
boundary.field_hi = {"pec " * ndim}
algo.maxwell_solver = {solver}
my_constants.theta = {ECT_THETA[ndim]!r}
my_constants.h2 = {2 * math.pi ** 2!r}
warpx.eb_implicit_function = "{ECT_CUBE[ndim]}"
warpx.B_ext_grid_init_style = parse_B_ext_grid_function
warpx.Bx_external_grid_function(x,y,z) = "{bx}"
warpx.By_external_grid_function(x,y,z) = "{by}"
warpx.Bz_external_grid_function(x,y,z) = "{bz}"
"""


def ect_steps(ndim):
    """The steps to ~1.125 periods of the mode at cfl 1 (3D at 64^3:
    omega = sqrt(2) pi c; 2D at 32^2: omega = pi c / 1.06)."""
    if ndim == 3:
        dt = 1.0 / (C_LIGHT * math.sqrt(3.0) / 0.025)
        omega = math.sqrt(2.0) * math.pi * C_LIGHT
    else:
        dt = 1.0 / (C_LIGHT * math.sqrt(2.0) / 0.05)
        omega = math.pi * C_LIGHT / 1.06
    return int(round(1.125 * 2 * math.pi / omega / dt))


def ect_mode_errors(fields, t, ndim, n):
    """The relative l2 errors of By (and Bz in 3D) against the analytic
    mode on the uncovered faces (analysis_fields_2d.py / _3d.py as the
    JAX package's tests/test_ect.py writes them)."""
    mu0 = 1.25663706212e-06
    dx = 1.6 / n
    theta = ECT_THETA[ndim]
    if ndim == 2:
        by = fields.By.double().cpu().numpy()[:n, :n]
        x = np.arange(n) * dx - 0.8
        X, Z = np.meshgrid(x, x, indexing="ij")
        zr = -X * np.sin(-theta) + Z * np.cos(-theta)
        th = (mu0 * np.cos(np.pi / 1.06 * (zr - 0.53))
              * np.cos(np.pi / 1.06 * C_LIGHT * t) * (by != 0))
        return {"By": float(np.sqrt(np.sum((by - th) ** 2)
                                    / np.sum(th ** 2)))}
    h2 = 2 * np.pi ** 2
    ct = np.cos(np.sqrt(2) * np.pi * C_LIGHT * t)

    def theory(shifts):
        x0 = (np.arange(n) + shifts[0]) * dx - 0.8
        y0 = (np.arange(n) + shifts[1]) * dx - 0.8
        z0 = (np.arange(n) + shifts[2]) * dx - 0.8
        _, Y0, Z0 = np.meshgrid(x0, y0, z0, indexing="ij")
        y = Y0 * np.cos(-theta) - Z0 * np.sin(-theta)
        z = Y0 * np.sin(-theta) + Z0 * np.cos(-theta)
        b_y = (-2 / h2 * mu0 * np.pi * np.pi * np.sin(np.pi * (y - 0.5))
               * np.cos(np.pi * (z - 0.5)) * ct)
        b_z = mu0 * np.cos(np.pi * (y - 0.5)) * np.sin(np.pi * (z - 0.5)) * ct
        return b_y, b_z

    out = {}
    by = fields.By.double().cpu().numpy()[:, :n, :n]
    t_y, t_z = theory([0.5, 0.0, 0.5])
    th = (t_y * np.cos(theta) - t_z * np.sin(theta)) * (by != 0)
    out["By"] = float(np.sqrt(np.sum((by - th) ** 2) / np.sum(th ** 2)))
    bz = fields.Bz.double().cpu().numpy()[:, :n, :n]
    t_y, t_z = theory([0.5, 0.5, 0.0])
    th = (t_y * np.sin(theta) + t_z * np.cos(theta)) * (bz != 0)
    out["Bz"] = float(np.sqrt(np.sum((bz - th) ** 2) / np.sum(th ** 2)))
    return out


EB_SPHERE = """
eb2.geom_type = sphere
eb2.sphere_center = {cx!r} 0. {cz!r}
eb2.sphere_radius = {r!r}
eb2.sphere_has_fluid_inside = 0
"""


def eb_plasma_deck(n, steps, span, ppc=1, filt=1):
    """A PEC box of 2 span per axis holding a plasma that streams into an
    eb2 sphere (reflecting x and z walls, absorbing y), Yee."""
    return f"""
max_step = {steps}
amr.n_cell = {n} {n} {n}
geometry.dims = 3
geometry.prob_lo = {-span!r} {-span!r} {-span!r}
geometry.prob_hi = {span!r} {span!r} {span!r}
warpx.cfl = 0.9
warpx.use_filter = {filt}
boundary.field_lo = pec pec pec
boundary.field_hi = pec pec pec
boundary.particle_lo = reflecting absorbing reflecting
boundary.particle_hi = reflecting absorbing reflecting
{EB_SPHERE.format(cx=span / 8, cz=-span / 8, r=span / 2)}
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = {ppc} {ppc} {ppc}
electrons.profile = constant
electrons.density = 1.e25
electrons.momentum_distribution_type = parse_momentum_function
electrons.momentum_function_ux(x,y,z) = "0.3*(1 - 2*(x > {span / 8!r}))"
electrons.momentum_function_uy(x,y,z) = "0.1"
electrons.momentum_function_uz(x,y,z) = "0.3*(1 - 2*(z > {-span / 8!r}))"
"""


def fieldsolver2_cases():
    """(name, deck text, steps)."""
    return [
        ("theta_picard_3d", implicit_deck(3, 16, 3), 3),
        ("semi_implicit_2d", implicit_deck(2, 32, 3, "semi_implicit_em"), 3),
        ("newton_gmres_2d", implicit_deck(2, 16, 1, extra=NEWTON_KEYS), 1),
        ("fluid_langmuir_3d", fluid_langmuir_deck(3, 16, 5), 5),
        ("ect_rotated_cube_2d", ect_cube_deck(2, 32, 10), 10),
        ("eb_sphere_3d", eb_plasma_deck(16, 4, 8e-6), 4),
    ]


def phase_fieldsolver2_parity(dev):
    """fieldsolver2_parity: Queue A 11.3's second half in float64, card
    against CPU: theta-implicit Picard at 16^3 (3 steps), semi-implicit at
    32^2 (3), Newton-GMRES at 16^2 (2), a 3D cold-fluid Langmuir deck at
    16^3 (5), the 2D ECT rotated cube at 32^2 (10), a bounded 3D Yee plasma
    streaming into an eb2 sphere at 16^3 (4), then ChargeOnEB on that
    state: every checksum within 1e-9 of its group's scale, the fluid
    state within 1e-9, the Picard and Newton iteration counts equal,
    ChargeOnEB within 1e-9."""
    import warpx_tpu_torch
    from warpx_tpu_torch.diagnostics.reduced import compute_reduced
    from warpx_tpu_torch.utils.parser import Deck

    cases = {}
    for name, text, steps in fieldsolver2_cases():
        sims = {}
        for device in (dev, "cpu"):
            t0 = time.perf_counter()
            sim = warpx_tpu_torch.Simulation.from_deck(
                Deck.from_string(text), dtype=torch.float64, device=device)
            sim.init()
            sim.evolve()
            if str(device) != "cpu":
                torch.cuda.synchronize()
            sims[str(device)] = (sim, time.perf_counter() - t0)
        (card, card_s), (cpu, cpu_s) = sims[str(dev)], sims["cpu"]
        if card.state.step != steps:
            raise AssertionError(f"fieldsolver2_parity {name}: "
                                 f"{card.state.step} steps")
        case = {"card_s": card_s, "cpu_s": cpu_s}
        for k, ref in cpu.state.aux.items():
            if k.startswith("fluid_"):
                err = rel_err(card.state.aux[k].cpu(), ref)[1]
                case[k] = err
                if err > 1e-9:
                    raise AssertionError(f"fieldsolver2_parity {name}: {k} "
                                         f"differs by {err}")
        if card.implicit is not None:
            got, ref = card.implicit.history, cpu.implicit.history
            if got != ref:
                raise AssertionError(f"fieldsolver2_parity {name}: "
                                     f"iterations {got} on the card, {ref} "
                                     "on the CPU")
            case["iterations"] = got
        if name == "eb_sphere_3d":
            q = [compute_reduced("ChargeOnEB", s.state, s.cfg, s.staggering,
                                 {})["Charge (C)"] for s in (card, cpu)]
            err = abs(q[0] - q[1]) / abs(q[1])
            if not q[1] or err > 1e-9:
                raise AssertionError(f"fieldsolver2_parity ChargeOnEB: {q}")
            case["charge_on_eb_C"] = q[0]
            case["charge_on_eb_rel_err"] = err
        case["max_rel_err"] = grouped_agree(
            card.checksums(), cpu.checksums(), 1e-9,
            f"fieldsolver2_parity {name}")
        cases[name] = case
    emit("fieldsolver2_parity", ok=True, tol=1e-9, cases=cases)


def total_energy(sim):
    """Field plus particle energy (J) of ``sim``'s state, from the
    reduced diagnostics FieldEnergy and ParticleEnergy."""
    from warpx_tpu_torch.diagnostics.reduced import compute_reduced

    fe = compute_reduced("FieldEnergy", sim.state, sim.cfg, sim.staggering)
    pe = compute_reduced("ParticleEnergy", sim.state, sim.cfg,
                         sim.staggering)
    return fe["total_lev0(J)"] + pe["total(J)"]


IMPLICIT_CFL = 0.5
TOL_IMPLICIT_DRIFT = 1e-10


def implicit_main_cfg(n=128, steps=2):
    """uniform-128-implicit: main_cfg's plasma (electrons and ions of the
    electron's mass, 2 a cell each, 8.39 M at n = 128, thermal 0.01 c) under
    the theta-implicit scheme at theta = 1/2 with Picard to 1e-12, dt at
    half the Courant limit (at the limit Picard stalls: the field part of
    its contraction is about (theta c dt k)^2), no filter, per particle."""
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    cfg = main_cfg(n, steps)
    return dataclasses.replace(
        cfg, dt=compute_dt_yee(cfg.geometry, IMPLICIT_CFL),
        evolve_scheme="theta_implicit_em", implicit_theta=0.5,
        picard_rtol=1e-12, picard_max_iterations=100,
        tiled_particles="off", use_filter=False)


def drive_implicit(sim, steps):
    """Init, then ``steps`` steps each timed by CUDA events, with the total
    energy before and after each step; then one right-hand-side
    evaluation (a Picard iteration's work: B, the particles' iterations,
    J, E) at the final state under the profiler (a whole step is ~100,000
    kernels, whose trace takes a minute to read back).  Returns (init_s,
    each step's ms, energies, the RHS's (device ms, launches, wall ms))."""
    t0 = time.perf_counter()
    sim.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    energies = [total_energy(sim)]
    series = []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        sim.evolve(1)
        b.record()
        b.synchronize()
        series.append(a.elapsed_time(b))
        energies.append(total_energy(sim))
    rhs, _ = implicit_rhs(sim)
    return init_s, series, energies, profile_call(rhs)


def implicit_rhs(sim):
    """(rhs(*e3), e3): the implicit step's right-hand side at ``sim``'s
    state, the particles starting from their momenta and positions."""
    imp, state = sim.implicit, sim.state
    ndim = sim.cfg.geometry.ndim
    f = state.fields
    e3, b3 = (f.Ex, f.Ey, f.Ez), (f.Bx, f.By, f.Bz)
    ub = {nm: (sp.ux, sp.uy, sp.uz) for nm, sp in state.species.items()}
    xh = {nm: tuple(sp.positions(ndim)) for nm, sp in state.species.items()}

    def rhs(*e):
        return imp._compute_rhs(e or e3, state, b3, ub, xh)[0]

    return rhs, e3


def phase_main_implicit(dev, smi, n=128, steps=1):
    """uniform-128-implicit (``implicit_main_cfg``), float64, 1 step (3,
    then 2, until the script needed the time for later phases): ms a
    step, the Picard iterations of each step, peak memory, busy share; the
    total energy's drift at most TOL_IMPLICIT_DRIFT relative, the fields
    finite, every particle kept."""
    import warpx_tpu_torch

    cfg = implicit_main_cfg(n, steps)
    torch.cuda.reset_peak_memory_stats()
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device=dev)
    if sim.implicit is None or sim.binned:
        raise AssertionError("main_implicit: not the implicit step")
    n0 = 2 * 2 * n ** 3
    init_s, series, energies, (rhs_dev, rhs_n, rhs_wall) = drive_implicit(
        sim, steps)
    drift = max(abs(e - energies[0]) for e in energies) / abs(energies[0])
    f = sim.state.fields
    finite = all(bool(torch.isfinite(getattr(f, nm)).all())
                 for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"))
    alive = sum(int(sp.alive.sum()) for sp in sim.state.species.values())
    iters = [h["iterations"] for h in sim.implicit.history]
    if not (drift <= TOL_IMPLICIT_DRIFT and finite and alive == n0
            and max(iters) < cfg.picard_max_iterations):
        raise AssertionError(f"main_implicit: drift {drift}, finite "
                             f"{finite}, {alive} alive of {n0}, Picard "
                             f"iterations {iters}")
    emit("main_implicit", ok=True, n_cell=cfg.geometry.n_cell,
         n_particles=n0, steps=sim.state.step, dtype="float64",
         dt=cfg.dt, cfl=IMPLICIT_CFL, theta=0.5,
         picard_rtol=cfg.picard_rtol, picard_iterations=iters,
         ms_per_step=sum(series) / len(series), ms_each_step=series,
         ms_per_picard_iteration=sum(series) / sum(iters),
         init_s=init_s, energy_J=energies, energy_drift=drift,
         energy_drift_tol=TOL_IMPLICIT_DRIFT,
         rhs_device_ms=rhs_dev, rhs_launches=rhs_n, rhs_wall_ms=rhs_wall,
         device_busy_share=rhs_dev / rhs_wall,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         nvidia_smi=smi)
    del sim


def jfnk_cfg(n=256, steps=1):
    """uniform2d-256-jfnk: main2d's plasma kind (electrons and ions of the
    electron's mass, thermal 0.01 c) at 256^2 with 4 particles a cell
    ((2, 1) a species), order 1, theta-implicit at theta = 1/2 with Newton
    (to 1e-12, at most 6 iterations) and GMRES (restart 30, to 1e-8, at
    most 2 restarts), 3 particle iterations (the energy drift is at
    roundoff with 3 as with 8, and a JVP costs about three times less),
    dt at half the Courant limit, no filter."""
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    cfg = plasma_cfg(2, n, (2, 1), 1, 0.01, "ions", steps)
    return dataclasses.replace(
        cfg, dt=compute_dt_yee(cfg.geometry, IMPLICIT_CFL),
        tiled_particles="off",
        evolve_scheme="theta_implicit_em", implicit_theta=0.5,
        implicit_nonlinear="newton", implicit_max_particle_iterations=3,
        newton_rtol=1e-12, newton_max_iterations=6, gmres_restart=30,
        gmres_rtol=1e-8, gmres_max_iterations=60, use_filter=False)


def phase_main_implicit_jfnk(dev, smi, n=256, steps=1):
    """uniform2d-256-jfnk (``jfnk_cfg``), float64, 1 step (2 until the
    script needed the time for later phases): the Newton iterations, GMRES
    restarts and Arnoldi steps (Jacobian-vector products) of each step, ms a step, one JVP's and one
    right-hand side's ms alone; the total energy's drift at most
    TOL_IMPLICIT_DRIFT relative, the fields finite."""
    import warpx_tpu_torch

    cfg = jfnk_cfg(n, steps)
    torch.cuda.reset_peak_memory_stats()
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device=dev)
    if sim.implicit is None:
        raise AssertionError("main_implicit_jfnk: not the implicit step")
    init_s, series, energies, (rhs_dev, _, rhs_wall) = drive_implicit(
        sim, steps)
    drift = max(abs(e - energies[0]) for e in energies) / abs(energies[0])
    f = sim.state.fields
    finite = all(bool(torch.isfinite(getattr(f, nm)).all())
                 for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"))
    if not (drift <= TOL_IMPLICIT_DRIFT and finite):
        raise AssertionError(f"main_implicit_jfnk: drift {drift}, finite "
                             f"{finite}, {sim.implicit.history}")
    # one right-hand side and one Jacobian-vector product alone, at the
    # final state
    imp = sim.implicit
    rhs, e3 = implicit_rhs(sim)
    v3 = tuple(torch.ones_like(a) for a in e3)
    rhs_ms = cuda_ms(lambda: rhs(*e3), 3)
    jvp_ms = cuda_ms(lambda: torch.func.jvp(rhs, e3, v3), 3)
    emit("main_implicit_jfnk", ok=True, n_cell=cfg.geometry.n_cell,
         n_particles=4 * n * n, steps=sim.state.step, dtype="float64",
         newton=imp.history, gmres_restart=cfg.gmres_restart,
         particle_iterations=cfg.implicit_max_particle_iterations,
         ms_per_step=sum(series) / len(series), ms_each_step=series,
         init_s=init_s, rhs_ms=rhs_ms, jvp_ms=jvp_ms,
         jvp_over_rhs=jvp_ms / rhs_ms, energy_J=energies,
         energy_drift=drift, energy_drift_tol=TOL_IMPLICIT_DRIFT,
         device_busy_share=rhs_dev / rhs_wall,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         nvidia_smi=smi)
    del sim


FLUID_OMEGA_DT = 0.1
FLUID_PERIODS = 2.0
TOL_FLUID_SUM = 1e-5
TOL_FLUID_OMEGA = 1e-2


def fluid_main_cfg(n=128):
    """fluid-128-langmuir: a cold electron fluid on main_cfg's 40 um box
    at 128^3, dt at 0.999 of the Courant limit, the density for omega_pe
    dt = FLUID_OMEGA_DT, u_x = u0 sin(k x) with k = 2 pi / 40 um and u0 =
    1e-3 c, over FLUID_PERIODS plasma periods (and one step more), no
    filter.  Returns (cfg, omega_pe)."""
    from warpx_tpu_torch.core.config import SimConfig, SpeciesConfig
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    lx = 40e-6
    geom = Geometry(ndim=3, n_cell=(n,) * 3, prob_lo=(-lx / 2,) * 3,
                    prob_hi=(lx / 2,) * 3, periodic=(True,) * 3)
    dt = compute_dt_yee(geom, 0.999)
    omega = FLUID_OMEGA_DT / dt
    density = omega ** 2 * EP0 * M_E / Q_E ** 2
    steps = int(math.ceil(FLUID_PERIODS * 2 * math.pi / FLUID_OMEGA_DT)) + 1
    fluid = SpeciesConfig(
        name="electrons", charge=-Q_E, mass=M_E, profile="constant",
        density=density, momentum_distribution="parse_momentum_function",
        momentum_exprs=(f"1.e-3*sin(2*pi*x/{lx!r})", "0", "0"),
        user_constants=(("pi", math.pi),))
    return SimConfig(geometry=geom, max_step=steps, dt=dt, fluids=(fluid,),
                     use_filter=False, tiled_particles="off"), omega


def phase_main_fluid(dev, smi, n=128):
    """fluid-128-langmuir (``fluid_main_cfg``), float32: after every step
    the x-Fourier amplitude of Ex (sum Ex sin(k x)) and sum N (float64);
    the wave's frequency from the amplitude's zero crossings (linear
    interpolation) within TOL_FLUID_OMEGA of omega_pe, sum N within
    TOL_FLUID_SUM of its start; ms a step."""
    import warpx_tpu_torch

    cfg, omega = fluid_main_cfg(n)
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    sim.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    geom = cfg.geometry
    xc = torch.as_tensor(geom.cell_centers(0), device=dev)
    sin_kx = torch.sin(2 * math.pi * (xc - geom.prob_lo[0])
                       / (geom.prob_hi[0] - geom.prob_lo[0]))
    key = "fluid_N:electrons"
    amps, sums = [], []

    def sample():
        ex = sim.state.fields.Ex.double().sum(dim=(1, 2))
        amps.append((ex * sin_kx).sum())
        sums.append(sim.state.aux[key].double().sum())

    sample()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(cfg.max_step):
        sim.evolve(1)
        sample()
    b.record()
    b.synchronize()
    ms_step = a.elapsed_time(b) / cfg.max_step
    amp = torch.stack(amps).cpu().numpy()
    total = torch.stack(sums).cpu().numpy()
    sum_err = float(np.abs(total - total[0]).max() / total[0])
    t = np.arange(len(amp)) * cfg.dt
    crossings = [t[i] - amp[i] * (t[i + 1] - t[i]) / (amp[i + 1] - amp[i])
                 for i in range(1, len(amp) - 1)
                 if amp[i] != 0 and amp[i] * amp[i + 1] < 0]
    omega_meas = (math.pi * (len(crossings) - 1)
                  / (crossings[-1] - crossings[0])
                  if len(crossings) >= 3 else float("nan"))
    omega_err = abs(omega_meas / omega - 1.0)
    finite = bool(torch.isfinite(sim.state.fields.Ex).all())
    if not (sum_err <= TOL_FLUID_SUM and omega_err <= TOL_FLUID_OMEGA
            and finite):
        raise AssertionError(f"main_fluid: sum N drift {sum_err}, omega "
                             f"{omega_meas} against {omega} "
                             f"({len(crossings)} crossings), finite "
                             f"{finite}")
    emit("main_fluid", ok=True, n_cell=geom.n_cell, steps=sim.state.step,
         dtype="float32", density_m3=cfg.fluids[0].density,
         omega_pe=omega, omega_measured=omega_meas, omega_rel_err=omega_err,
         omega_tol=TOL_FLUID_OMEGA, periods=FLUID_PERIODS,
         zero_crossings=len(crossings), sum_n_drift=sum_err,
         sum_n_tol=TOL_FLUID_SUM, ms_per_step=ms_step, init_s=init_s,
         nvidia_smi=smi)
    del sim


TOL_ECT_MODE = {3: 1e-2, 2: 1e-1}
ECT_N = {3: 64, 2: 32}


def phase_main_ect(dev, smi):
    """The reference's rotated-cube TM eigenmode under ECT in 3D at 64^3
    (theta = pi/6) and 2D at 32^2 (theta = pi/8), float64, ~1.125 periods
    from the mode laid through the external grid fields: the relative l2
    error of By and Bz (3D) or By (2D) against the analytic pattern below
    TOL_ECT_MODE (the reference's analyses); reported without a gate: the
    same with algo.maxwell_solver = yee on the same staircase boundary,
    the host time of the cut-cell geometry, ms a step."""
    import warpx_tpu_torch
    from warpx_tpu_torch.solvers import ect
    from warpx_tpu_torch.utils.parser import Deck

    out = {}
    for ndim in (3, 2):
        n, steps = ECT_N[ndim], ect_steps(ndim)
        res = {"n_cell": n, "steps": steps}
        for solver in ("ect", "yee"):
            ect._GEO_CACHE.clear()
            sim = warpx_tpu_torch.Simulation.from_deck(
                Deck.from_string(ect_cube_deck(ndim, n, steps, solver)),
                dtype=torch.float64, device=dev)
            t0 = time.perf_counter()
            sim.init()
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            sim.evolve()
            b.record()
            b.synchronize()
            errs = ect_mode_errors(sim.state.fields, float(sim.state.time),
                                   ndim, n)
            res[solver] = {"errors": errs, "init_s": init_s,
                           "ms_per_step": a.elapsed_time(b) / steps}
            if solver == "ect":
                if sim.stepper.ect_evolve_b is None:
                    raise AssertionError("main_ect: not the ECT update")
                t0 = time.perf_counter()
                ect._GEO_CACHE.clear()
                ect.cached_ect_geometry(
                    sim.cfg.eb_implicit_function,
                    tuple(sim.cfg.user_constants), sim.cfg.geometry,
                    tuple(sim.cfg.geometry.prob_lo))
                res["geometry_host_s"] = time.perf_counter() - t0
                bad = {k: v for k, v in errs.items()
                       if not v < TOL_ECT_MODE[ndim]}
                if bad:
                    raise AssertionError(f"main_ect {ndim}D: mode errors "
                                         f"{bad} above {TOL_ECT_MODE[ndim]}")
            del sim
        out[f"{ndim}d"] = res
    emit("main_ect", ok=True, tol=TOL_ECT_MODE, nvidia_smi=smi, **out)


EB_MAIN_STEPS = 5


def eb_main_cfg(n=128, steps=EB_MAIN_STEPS):
    """uniform-128-eb: main_cfg's plasma (8.39 M particles) in a PEC box
    of its 40 um with an eb2 sphere of radius 10 um off center, reflecting
    walls, Yee, per particle."""
    import warpx_tpu_torch
    from warpx_tpu_torch.utils.parser import Deck

    cfg = main_cfg(n, steps)
    eb = warpx_tpu_torch.core.deck._eb2_implicit_function(Deck.from_string(
        "geometry.dims = 3\n" + EB_SPHERE.format(cx=2.5e-6, cz=-2.5e-6,
                                                 r=10e-6)))
    return dataclasses.replace(
        cfg, geometry=dataclasses.replace(cfg.geometry,
                                          periodic=(False,) * 3),
        field_bc_lo=("pec",) * 3, field_bc_hi=("pec",) * 3,
        particle_bc_lo=("reflecting",) * 3,
        particle_bc_hi=("reflecting",) * 3,
        eb_implicit_function=eb, tiled_particles="off")


def phase_main_eb(dev, smi, n=128, steps=EB_MAIN_STEPS):
    """uniform-128-eb (``eb_main_cfg``), float32, 5 steps; after every
    step: no alive particle inside the body, every covered E edge and B
    face bitwise equal to its initial value, the fields finite; ChargeOnEB
    at the end and ms a step."""
    import warpx_tpu_torch
    from warpx_tpu_torch.diagnostics.reduced import compute_reduced

    cfg = eb_main_cfg(n, steps)
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    sim.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if not sim.is_bounded or sim.binned or sim.stepper.eb_mask is None:
        raise AssertionError("main_eb: not the bounded step with an EB")
    masks = sim.stepper.eb_mask
    frozen0 = {nm: getattr(sim.state.fields, nm)[~m].clone()
               for nm, m in masks.items()}
    n_inside0 = sum(int((sim.stepper.inside_eb(sp.positions(3))
                         & sp.alive).sum())
                    for sp in sim.state.species.values())
    series, removed = [], []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        sim.evolve(1)
        b.record()
        b.synchronize()
        series.append(a.elapsed_time(b))
        f = sim.state.fields
        inside = sum(int((sim.stepper.inside_eb(sp.positions(3))
                          & sp.alive).sum())
                     for sp in sim.state.species.values())
        frozen = all(torch.equal(getattr(f, nm)[~m], frozen0[nm])
                     for nm, m in masks.items())
        finite = all(bool(torch.isfinite(getattr(f, nm)).all())
                     for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"))
        removed.append(sum(int(sp.alive.sum())
                           for sp in sim.state.species.values()))
        if inside or not frozen or not finite:
            raise AssertionError(f"main_eb step {sim.state.step}: {inside} "
                                 f"alive inside, covered frozen {frozen}, "
                                 f"finite {finite}")
    q = compute_reduced("ChargeOnEB", sim.state, cfg, sim.staggering, {})
    emit("main_eb", ok=True, n_cell=cfg.geometry.n_cell,
         n_particles=2 * 2 * n ** 3, steps=sim.state.step, dtype="float32",
         inside_at_init=n_inside0, alive_each_step=removed,
         covered={nm: int((~m).sum()) for nm, m in masks.items()},
         charge_on_eb_C=q["Charge (C)"], ms_per_step=sum(series) / steps,
         ms_each_step=series, init_s=init_s, nvidia_smi=smi)
    del sim


# ---- the bounded branches of Queue A 11.4 and hybrid QED -------------------

def walls_deck(ndim, faces, particle_bc, steps=6, n=None, extra="", u_th=0.1,
               tiled="off"):
    """A box of ``faces`` field boundaries on every side (``particle_bc``
    particle ones) holding a warm electron plasma: 32^2 in 2D, 16^3 in 3D
    (``n`` cells a side otherwise), one particle per cell, or tile-binned
    (``tiled`` on) 3 x 3 or 1 x 1 x 3 (a species of 8192 particles or fewer
    keeps its compact layout and never reaches the fused kernel)."""
    n = n or (32 if ndim == 2 else 16)
    ppc = ["1"] * ndim
    if tiled == "on":
        ppc[-1] = "3"
        ppc[0] = "3" if ndim == 2 else "1"
    span = " ".join(["-8.e-6"] * ndim), " ".join(["8.e-6"] * ndim)
    return f"""
max_step = {steps}
amr.n_cell = {" ".join([str(n)] * ndim)}
geometry.dims = {ndim}
geometry.prob_lo = {span[0]}
geometry.prob_hi = {span[1]}
boundary.field_lo = {" ".join([faces] * ndim)}
boundary.field_hi = {" ".join([faces] * ndim)}
boundary.particle_lo = {" ".join([particle_bc] * ndim)}
boundary.particle_hi = {" ".join([particle_bc] * ndim)}
warpx.cfl = 0.98
algo.particle_shape = 2
tpu.tiled_particles = {tiled}
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = {" ".join(ppc)}
electrons.profile = constant
electrons.density = 1.e24
electrons.momentum_distribution_type = gaussian
electrons.ux_th = {u_th}
electrons.uy_th = {u_th}
electrons.uz_th = {u_th}
""" + extra


def random_eb_hook(seed=7):
    """A hook writing seeded random E (~1e10 V/m) and B (~30 T) of the
    state's shapes into the fields after init (every guard of a
    Silver-Mueller face then carries a value)."""
    def hook(sim):
        rng = np.random.default_rng(seed)
        f = sim.state.fields
        sim.state = sim.state.replace(fields=f.replace(**{
            nm: torch.as_tensor(
                rng.normal(size=tuple(getattr(f, nm).shape))
                * (30.0 if nm[0] == "B" else 1e10),
                dtype=f.Ex.dtype, device=f.Ex.device)
            for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz")}))
    return hook


BEAM_3D_DECK = """
max_step = 8
amr.n_cell = 16 16 16
geometry.dims = 3
geometry.prob_lo = -8.e-6 -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6  8.e-6
warpx.cfl = 0.98
algo.particle_shape = 1
particles.species_names = electrons beam
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1 1
electrons.profile = constant
electrons.density = 1.e23
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.01
electrons.uy_th = 0.01
electrons.uz_th = 0.01
beam.species_type = electron
beam.injection_style = gaussian_beam
beam.x_rms = 2.e-6
beam.y_rms = 2.e-6
beam.z_rms = 1.e-6
beam.z_m = -4.e-6
beam.npart = 500
beam.q_tot = -1.e-14
beam.momentum_distribution_type = gaussian
beam.uz_m = 50.
beam.ux_th = 0.5
beam.uy_th = 0.5
beam.uz_th = 1.
beam.do_not_deposit = 1
"""

LATTICE_DECK = """
lattice.elements = d1 q1 d2 l1
d1.type = drift
d1.ds = -6.e-6
q1.type = quad
q1.ds = 5.e-6
q1.dEdx = 1.e14
q1.dBdx = 3.e5
d2.type = drift
d2.ds = 1.e-6
l1.type = plasmalens
l1.ds = 5.e-6
l1.dEdx = 2.e14
l1.dBdx = 1.e5
"""

WINDOW_WARM_DECK = """
max_step = 8
amr.n_cell = 16 64
geometry.dims = 2
geometry.prob_lo = -8.e-6 -24.e-6
geometry.prob_hi =  8.e-6   8.e-6
boundary.field_lo = pec pml
boundary.field_hi = pec pml
warpx.cfl = 0.98
warpx.do_moving_window = 1
warpx.moving_window_dir = z
warpx.moving_window_v = 1.0
warpx.sort_intervals = 4
algo.particle_shape = 2
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 2
electrons.xmin = -6.e-6
electrons.xmax =  6.e-6
electrons.zmin = -20.e-6
electrons.density = 2.e23
electrons.do_continuous_injection = 1
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.01
electrons.uy_th = 0.02
electrons.uz_th = 0.01
electrons.uz_m = 0.001
"""

HYBRID_QED_XI = 1.0e-23
QED_TRAVEL = 20e-6
HYBRID_QED_ES = 1.0e5


def hybrid_qed_deck(nx, nz, steps, lo_z, hi_z, amp=1.0e2, waist=2.0e-6):
    """A 2D collocated PSATD box with the Heisenberg-Euler correction
    (warpx.use_hybrid_QED, quantum_xi = HYBRID_QED_XI): a static Ey of
    HYBRID_QED_ES and a Gaussian pulse (Ey, Bx = -Ey / c) of ``amp`` at
    z = 0 travelling along +z; periodic, x uniform."""
    half_x = 0.05e-6 * nx
    return f"""
max_step = {steps}
amr.n_cell = {nx} {nz}
geometry.dims = 2
geometry.prob_lo = {-half_x} {lo_z}
geometry.prob_hi = {half_x} {hi_z}
warpx.grid_type = collocated
warpx.cfl = 0.7
warpx.use_filter = 0
algo.maxwell_solver = psatd
algo.current_deposition = direct
warpx.use_hybrid_QED = 1
warpx.quantum_xi = {HYBRID_QED_XI}
particles.species_names =
warpx.E_ext_grid_init_style = parse_E_ext_grid_function
warpx.Ex_external_grid_function(x,y,z) = 0.
warpx.Ey_external_grid_function(x,y,z) = {HYBRID_QED_ES} + {amp}*exp(-(z/{waist})**2)
warpx.Ez_external_grid_function(x,y,z) = 0.
warpx.B_ext_grid_init_style = parse_B_ext_grid_function
warpx.Bx_external_grid_function(x,y,z) = -{amp}/299792458.*exp(-(z/{waist})**2)
warpx.By_external_grid_function(x,y,z) = 0.
warpx.Bz_external_grid_function(x,y,z) = 0.
"""


COLLOCATED_DECK_KEYS = {
    "yee_periodic_mc": "warpx.grid_type = collocated\n"
                       "algo.field_gathering = momentum-conserving\n",
    "psatd_periodic": "warpx.grid_type = collocated\n"
                      "algo.maxwell_solver = psatd\n"
                      "algo.current_deposition = direct\n",
    "yee_bounded": "warpx.grid_type = collocated\n",
    "psatd_bounded_mc": "warpx.grid_type = collocated\n"
                        "algo.maxwell_solver = psatd\n"
                        "algo.current_deposition = direct\n"
                        "algo.field_gathering = momentum-conserving\n",
    "staggered_bounded_mc": "algo.field_gathering = momentum-conserving\n",
}


def boundaries_parity_cases():
    """(name, deck text, hook, tile-binned?, scraped faces): small decks of
    every branch Queue A 11.4 and hybrid QED brought."""
    boosted = (LWFA_32X64_DECK.replace("max_step = 12", "max_step = 6")
               + "warpx.gamma_boost = 10.\nwarpx.boost_direction = z\n"
               + "particles.rigid_injected_species = beam\n"
               + "beam.zinject_plane = -13.e-6\n")
    scrape = ("electrons.save_particles_at_xlo = 1\n"
              "electrons.save_particles_at_xhi = 1\n"
              "electrons.save_particles_at_zlo = 1\n"
              "electrons.save_particles_at_zhi = 1\n")
    eb = ("eb2.geom_type = sphere\neb2.sphere_center = 0. 0. 0.\n"
          "eb2.sphere_radius = 3.e-6\neb2.sphere_has_fluid_inside = 0\n"
          "electrons.save_particles_at_eb = 1\n"
          "electrons.save_particles_at_zhi = 1\n")
    periodic = {k: walls_deck(2, "periodic", "periodic", 5, u_th=0.2) + v
                for k, v in COLLOCATED_DECK_KEYS.items() if "periodic" in k}
    bounded = {k: walls_deck(2, "pec" if "yee" in k else "pml", "absorbing",
                             5, u_th=0.2) + v
               for k, v in COLLOCATED_DECK_KEYS.items()
               if "bounded" in k}
    cases = [
        ("silver_mueller_2d", walls_deck(
            2, "absorbing_silver_mueller", "absorbing"), random_eb_hook(),
         False, ()),
        ("silver_mueller_3d_binned", walls_deck(
            3, "absorbing_silver_mueller", "absorbing", steps=4,
            tiled="on"), random_eb_hook(), True, ()),
        ("thermal_walls_2d_binned", walls_deck(
            2, "pec", "thermal", steps=4, u_th=0.3, tiled="on")
         + "boundary.electrons.u_th = 0.05\n", None, True, ()),
        ("scraping_2d_binned", walls_deck(
            2, "pec", "absorbing", steps=4, u_th=0.3, tiled="on") + scrape,
         None, True, ("xlo", "xhi", "zlo", "zhi")),
        ("scraping_eb_3d", walls_deck(3, "pec", "absorbing", steps=4,
                                      u_th=0.3) + eb, None, False,
         ("eb", "zhi")),
    ]
    cases += [(f"collocated_{k}", v, None, False, ())
              for k, v in sorted({**periodic, **bounded}.items())]
    cases += [
        ("hybrid_qed_2d", hybrid_qed_deck(16, 64, 10, -16e-6, 16e-6), None,
         False, ()),
        ("rigid_lab_3d", BEAM_3D_DECK + "particles.rigid_injected_species "
         "= beam\nbeam.zinject_plane = -2.e-6\n", None, False, ()),
        ("rigid_boosted_2d", boosted + "tpu.tiled_particles = off\n", None,
         False, ()),
        ("lattice_3d", BEAM_3D_DECK + LATTICE_DECK, None, False, ()),
        ("do_not_3d_bounded", BEAM_3D_DECK.replace(
            "beam.do_not_deposit = 1",
            "beam.do_not_push = 1\nelectrons.do_not_gather = 1")
         + "boundary.field_lo = pec pec pec\n"
           "boundary.field_hi = pec pec pec\n", None, False, ()),
        ("gaussian_injection_window", WINDOW_WARM_DECK
         + "electrons.profile = parse_density_function\n"
           "electrons.density_function(x,y,z) = "
           "2.e23*(1+0.5*sin(z*1.e6))\ntpu.tiled_particles = off\n",
         None, False, ()),
        ("gaussian_injection_window_binned", WINDOW_WARM_DECK
         + "electrons.profile = constant\ntpu.tiled_particles = on\n",
         None, True, ()),
    ]
    return cases


def phase_boundaries_parity(dev):
    """boundaries_parity: every branch of Queue A 11.4 and hybrid QED in
    float64, card against CPU on the same numbers (``CpuDraws``): absorbing
    Silver-Mueller faces under random initial fields (2D per particle, 3D
    tile-binned), thermal walls and the scraping buffers on every face
    (tile-binned), the buffers at an embedded sphere, collocated Yee and
    PSATD with and without momentum-conserving gathering, periodic and
    bounded, momentum-conserving gathering on the staggered bounded grid,
    hybrid QED, rigid injection in the lab and in a boosted frame, the
    lattice, the do_not_* species, Gaussian continuous injection under a
    moving window per particle (parsed density) and tile-binned.  Fields and
    species within 1e-12 of their largest values per particle (1e-11 for
    hybrid QED, whose static field is 1000 times its pulse), 1e-9
    tile-binned (the deposit's atomics sum in another order), checksums and
    the scraped records within 1e-9; the tile-binned cases must launch the
    fused kernel (K1 in 3D, K2 in 2D, in the bounded frame) and K3."""
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling

    out = {}
    for name, text, hook, binned, faces in boundaries_parity_cases():
        counters = (fp.binned_push_deposit.launches,
                    fp.binned_push_deposit.launches_2d,
                    tiling.ragged_expand.launches)
        t0 = time.perf_counter()
        card = stochastic_run(text, dev, torch.float64, hook)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        k1_n = fp.binned_push_deposit.launches - counters[0]
        k2_n = fp.binned_push_deposit.launches_2d - counters[1]
        k3_n = tiling.ragged_expand.launches - counters[2]
        t0 = time.perf_counter()
        cpu = stochastic_run(text, "cpu", torch.float64, hook)
        cpu_s = time.perf_counter() - t0
        if card.binned != binned or (binned and not ((k1_n or k2_n)
                                                     and k3_n)):
            raise AssertionError(f"boundaries_parity {name}: binned "
                                 f"{card.binned}, K1 {k1_n}, K2 {k2_n}, "
                                 f"K3 {k3_n}")
        # hybrid QED's static Ey is 1000 times its pulse: the transforms'
        # roundoff of it (cuFFT against pocketfft) reaches ~1e-12 of the
        # pulse's B in 10 steps
        tol = (1e-9 if binned else 1e-11 if name == "hybrid_qed_2d"
               else 1e-12)
        worst = states_agree(card, cpu, tol, f"boundaries_parity {name}")
        records = {}
        for face in faces:
            got = card.scraped_particles("electrons", face)
            ref = cpu.scraped_particles("electrons", face)
            if set(got) != set(ref) or got["w"].shape != ref["w"].shape:
                raise AssertionError(f"boundaries_parity {name}: {face} "
                                     f"recorded {got['w'].shape} and "
                                     f"{ref['w'].shape}")
            for k, a in ref.items():
                err = rel_err(torch.as_tensor(got[k]),
                              torch.as_tensor(a))[1]
                if not err <= 1e-9:
                    raise AssertionError(f"boundaries_parity {name}: {face} "
                                         f"{k} differs by {err}")
            records[face] = int(ref["w"].shape[0])
        if faces and not sum(records.values()):
            raise AssertionError(f"boundaries_parity {name}: no record")
        worst_sum = checksums_agree(card.checksums(), cpu.checksums(), 1e-9,
                                    f"boundaries_parity {name}")
        out[name] = {"tol": tol, "max_rel_err": worst,
                     "checksum_max_rel_err": worst_sum, "binned": binned,
                     "k1_launches": k1_n, "k2_launches": k2_n,
                     "k3_launches": k3_n, "scraped": records,
                     "alive": {nm: int(sp.alive.sum())
                               for nm, sp in card.state.species.items()},
                     "card_s": card_s, "cpu_s": cpu_s}
    emit("boundaries_parity", ok=True, cases=out)


WALLS_STEPS = 10
WALLS_U_TH = 0.05


def walls_thermal_cfg(n=2048, steps=WALLS_STEPS):
    """uniform2d-2048's plasma in a PEC box with thermal walls on its four
    faces re-emitting at WALLS_U_TH, the plasma at that temperature too
    (the reference's particle_thermal_boundary physics), tile-binned at a
    sort interval of 8 with a margin of 2 cells (a 7-sigma particle drifts
    two cells in 8 steps)."""
    cfg = main2d_cfg(n, steps)
    species = tuple(dataclasses.replace(
        s, ux_th=WALLS_U_TH, uy_th=WALLS_U_TH, uz_th=WALLS_U_TH,
        boundary_u_th=WALLS_U_TH) for s in cfg.species)
    return dataclasses.replace(
        cfg, geometry=dataclasses.replace(cfg.geometry,
                                          periodic=(False, False)),
        species=species, field_bc_lo=("pec", "pec"),
        field_bc_hi=("pec", "pec"), particle_bc_lo=("thermal", "thermal"),
        particle_bc_hi=("thermal", "thermal"), sort_interval=8,
        sort_margin=2)


SCRAPE_STEPS = 10


def walls_scrape_cfg(n=128, steps=SCRAPE_STEPS):
    """uniform-128's plasma drifting at +0.1 c along z between absorbing z
    faces (PEC for the fields) that record what they absorb
    (save_particles_at_zlo/zhi), periodic across, tile-binned."""
    cfg = main_cfg(n, steps)
    u = 0.1 / math.sqrt(1.0 - 0.01)
    species = tuple(dataclasses.replace(s, uz=u,
                                        save_particles_at=("zlo", "zhi"))
                    for s in cfg.species)
    return dataclasses.replace(
        cfg, geometry=dataclasses.replace(cfg.geometry,
                                          periodic=(True, True, False)),
        species=species, field_bc_lo=("periodic", "periodic", "pec"),
        field_bc_hi=("periodic", "periodic", "pec"),
        particle_bc_lo=("periodic", "periodic", "absorbing"),
        particle_bc_hi=("periodic", "periodic", "absorbing"))


def phase_main_walls(dev, smi, k1_row, k1c_row, k3_row, n2=2048, n3=128):
    """main_walls_thermal: ``walls_thermal_cfg`` (33.5 M particles) bounded
    and tile-binned (K2 in the bounded frame, K3), WALLS_STEPS steps,
    float32: the alive count unchanged, every particle inside the box, u_rms
    within [0.5, 2] u_th (tests/test_pusher_external.py:106-114); ms a
    step, the thermal re-emission's device ms alone (every face draws
    full-capacity vectors: 24 rounds of two uniforms for the normal
    component, a normal each for the others), K2's ms and busy share.
    main_walls_scrape: ``walls_scrape_cfg`` tile-binned (K1 in the bounded
    frame, K3), SCRAPE_STEPS steps: the alive count falls by exactly the
    buffers' count, every record lies beyond its face, the alive weight
    plus the recorded weight equals the initial weight to float32
    roundoff.  Adds the launches to the rows of K1c ('f32'), K1 and K3."""
    import warpx_tpu_torch
    from warpx_tpu_torch.core import bounded_step as bs_mod
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling

    # --- thermal walls
    cfg = walls_thermal_cfg(n2)
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    if not (sim.is_bounded and sim.binned and sim.draws is not None):
        raise AssertionError("main_walls_thermal did not take the bounded "
                             "tile-binned step with draws")
    t0 = time.perf_counter()
    sim.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n0 = sum(int(sp.alive.sum()) for sp in sim.state.species.values())
    fp.binned_push_deposit.launches_2d = 0
    tiling.ragged_expand.launches = 0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with timed_fn(bs_mod.BoundedStepper, "_thermalize") as th_t, \
            timed_fn(bs_mod, "binned_push_deposit") as k_t:
        a.record()
        sim.evolve()
        b.record()
        b.synchronize()
        th_ms, k_ms = th_t.ms(), k_t.ms()
    launches = {"fused_pic_2d": fp.binned_push_deposit.launches_2d,
                "ragged_expand": tiling.ragged_expand.launches}
    ms_step = a.elapsed_time(b) / cfg.max_step
    if sim.state.step != cfg.max_step or not all(launches.values()):
        raise AssertionError(f"main_walls_thermal: {sim.state.step} steps, "
                             f"launches {launches}")
    geom = cfg.geometry
    alive = inside = 0
    usq = nu = 0.0
    for sp in sim.state.species.values():
        m = sp.alive
        alive += int(m.sum())
        ok = m.clone()
        for d, p in enumerate(sp.positions(2)):
            ok &= (p >= geom.prob_lo[d]) & (p <= geom.prob_hi[d])
        inside += int(ok.sum())
        usq += float((sp.ux[m].double() ** 2).sum())
        nu += int(m.sum())
    u_rms = math.sqrt(usq / nu) / C_LIGHT
    sums = sim.checksums()
    finite = all(np.isfinite(v) for g in sums.values() for v in g.values())
    if not (alive == n0 == inside and 0.5 * WALLS_U_TH < u_rms
            < 2.0 * WALLS_U_TH and finite):
        raise AssertionError(f"main_walls_thermal: alive {alive} of {n0}, "
                             f"inside {inside}, u_rms {u_rms}, finite "
                             f"{finite}")
    k_total = sum(k_ms)
    emit("main_walls_thermal", ok=True, n_cell=geom.n_cell, particles=n0,
         steps=cfg.max_step, dtype="float32", u_th=WALLS_U_TH,
         alive_at_end=alive, inside=inside, u_rms=u_rms,
         u_rms_bounds=[0.5 * WALLS_U_TH, 2.0 * WALLS_U_TH],
         ms_per_step=ms_step, init_s=init_s,
         thermal_ms_per_step=sum(th_ms) / cfg.max_step,
         thermal_calls=len(th_ms),
         thermal_share=sum(th_ms) / (ms_step * cfg.max_step),
         fused_pic_2d_ms=k_total / max(len(k_ms), 1),
         fused_pic_2d_busy_share=k_total / (ms_step * cfg.max_step),
         slots=sim.tile_spec.capacity, launches=launches, nvidia_smi=smi)
    add_launches({"fused_pic_moving_window": k1c_row,
                  "ragged_expand": k3_row},
                 {"fused_pic_moving_window": launches["fused_pic_2d"],
                  "ragged_expand": launches["ragged_expand"]},
                 "main_walls_thermal")
    del sim
    torch.cuda.empty_cache()

    # --- scraping buffers
    cfg = walls_scrape_cfg(n3)
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    if not (sim.is_bounded and sim.binned):
        raise AssertionError("main_walls_scrape did not take the bounded "
                             "tile-binned step")
    sim.init()
    n0 = sum(int(sp.alive.sum()) for sp in sim.state.species.values())
    w0 = sum(float(sp.w[sp.alive].double().sum())
             for sp in sim.state.species.values())
    fp.binned_push_deposit.launches = 0
    tiling.ragged_expand.launches = 0
    a.record()
    sim.evolve()
    b.record()
    b.synchronize()
    ms_step = a.elapsed_time(b) / cfg.max_step
    launches = {"fused_pic": fp.binned_push_deposit.launches,
                "ragged_expand": tiling.ragged_expand.launches}
    if not all(launches.values()):
        raise AssertionError(f"main_walls_scrape launched {launches}")
    geom = cfg.geometry
    alive = sum(int(sp.alive.sum()) for sp in sim.state.species.values())
    w_alive = sum(float(sp.w[sp.alive].double().sum())
                  for sp in sim.state.species.values())
    recorded = {}
    w_rec = 0.0
    for sp_cfg in cfg.species:
        for face in sp_cfg.save_particles_at:
            rec = sim.scraped_particles(sp_cfg.name, face)
            z = rec["p2"]
            beyond = (z < geom.prob_lo[2]) if face == "zlo" else (
                z > geom.prob_hi[2])
            if not beyond.all():
                raise AssertionError(f"main_walls_scrape: a {face} record "
                                     "lies inside the box")
            if rec["w"].shape[0] > sim.state.species[sp_cfg.name].capacity:
                raise AssertionError("main_walls_scrape: the buffer "
                                     "overflowed")
            recorded[f"{sp_cfg.name}:{face}"] = int(rec["w"].shape[0])
            w_rec += float(rec["w"].astype(np.float64).sum())
    n_rec = sum(recorded.values())
    w_err = abs(w_alive + w_rec - w0) / w0
    if not (n_rec > 0 and alive == n0 - n_rec and w_err < 1e-6):
        raise AssertionError(f"main_walls_scrape: {n0} -> {alive} alive, "
                             f"{n_rec} recorded, weight off by {w_err}")
    emit("main_walls_scrape", ok=True, n_cell=geom.n_cell, particles=n0,
         steps=cfg.max_step, dtype="float32", drift_beta=0.1,
         alive_at_end=alive, recorded=recorded, weight_rel_err=w_err,
         ms_per_step=ms_step, launches=launches, nvidia_smi=smi)
    add_launches({"fused_pic": k1_row, "ragged_expand": k3_row},
                 launches, "main_walls_scrape")
    del sim


SM_LAMBDA = 0.8e-6
SM_TAU = 2.0 * SM_LAMBDA / C_LIGHT


def silver_mueller_deck(n, faces, steps):
    """A 2D vacuum box of n^2 cells of lambda / 16 with ``faces`` on all four
    sides and a Gaussian antenna at its centre along +z (the reference's
    silver_mueller 2D deck's pulse): two wavelengths long, its peak at
    four durations (a smooth turn-on), a waist of 1/8 of the box."""
    dx = SM_LAMBDA / 16.0
    half = 0.5 * n * dx
    tau = SM_TAU
    return f"""
max_step = {steps}
amr.n_cell = {n} {n}
geometry.dims = 2
geometry.prob_lo = {-half} {-half}
geometry.prob_hi = {half} {half}
boundary.field_lo = {faces} {faces}
boundary.field_hi = {faces} {faces}
warpx.cfl = 0.99
warpx.use_filter = 0
tpu.tiled_particles = off
particles.species_names =
lasers.names = laser1
laser1.profile = Gaussian
laser1.position = 0. 0. 0.
laser1.direction = 0. 0. 1.
laser1.polarization = 0. 1. 0.
laser1.e_max = 1.e9
laser1.profile_waist = {n * dx / 8.0}
laser1.profile_duration = {tau}
laser1.profile_t_peak = {4.0 * tau}
laser1.profile_focal_distance = 0.
laser1.wavelength = {SM_LAMBDA}
"""


SM_PML_TWIN_STEPS = 200


def phase_main_silver_mueller(dev, smi, n=2048):
    """main_silver_mueller: ``silver_mueller_deck`` at 2048^2 with absorbing
    Silver-Mueller faces, float32, until the pulse's tail has crossed the
    half box plus 10 %: max |E| sampled every 50 steps; the pulse exists
    (max |E| > 1 V/m part-way) and, once it has left, max |E| is below 3 %
    of its peak (tests/test_silver_mueller.py:38, :52); ms a step.  The same
    pulse with PML faces for SM_PML_TWIN_STEPS steps, its ms a step
    reported beside (its residual after the pulse left is not measured:
    the twin ran the whole crossing until the script needed the time)."""
    import warpx_tpu_torch
    from warpx_tpu_torch.utils.parser import Deck

    dx = SM_LAMBDA / 16.0
    out = {}
    for faces in ("absorbing_silver_mueller", "pml"):
        probe = warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(silver_mueller_deck(n, faces, 1)),
            dtype=torch.float32, device=dev)
        dt = probe.cfg.dt
        steps = int(math.ceil((8.0 * SM_TAU + 1.1 * 0.5 * n * dx / C_LIGHT)
                              / dt / 50.0)) * 50
        if faces == "pml":
            steps = SM_PML_TWIN_STEPS
        del probe
        sim = warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(silver_mueller_deck(n, faces, steps)),
            dtype=torch.float32, device=dev)
        sim.init()
        peaks = []
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        while sim.state.step < steps:
            sim.evolve(50)
            f = sim.state.fields
            peaks.append(torch.stack([getattr(f, c).abs().max()
                                      for c in ("Ex", "Ey", "Ez")]).max())
        b.record()
        b.synchronize()
        peaks = [float(p) for p in torch.stack(peaks).cpu()]
        ms_step = a.elapsed_time(b) / steps
        f = sim.state.fields
        stepper = sim.stepper
        residual = max(float(getattr(f, c).abs().max())
                       for c in ("Ex", "Ey", "Ez"))
        peak = max(peaks)
        out[faces] = {"steps": steps, "dt": dt, "peak_V_m": peak,
                      "part_way_V_m": peaks[len(peaks) // 3],
                      "residual_V_m": residual,
                      "residual_of_peak": residual / peak,
                      "ms_per_step": ms_step,
                      "field_shape": list(stepper.shapes["Ey"])}
        if faces == "pml":
            # the pulse has not left the box yet
            out[faces].update(residual_V_m="not measured",
                              residual_of_peak="not measured")
        del sim
        torch.cuda.empty_cache()
    sm = out["absorbing_silver_mueller"]
    if not (sm["part_way_V_m"] > 1.0 and sm["residual_of_peak"] < 0.03):
        raise AssertionError(f"main_silver_mueller: {sm}")
    emit("main_silver_mueller", ok=True, n_cell=[n, n], dtype="float32",
         residual_tol_of_peak=0.03, silver_mueller=sm, pml=out["pml"],
         nvidia_smi=smi)


LANGMUIR_U0 = 0.05
LANGMUIR_STEPS = 64
LANGMUIR_PERIOD_STEPS = 36


def collocated_langmuir_cfg(n=128, steps=LANGMUIR_STEPS, solver="psatd"):
    """uniform-128's plasma (electrons and their equal-mass opposite
    species, u_th 0.01) on a collocated grid with momentum-conserving
    gathering, per particle, its density lowered so that the pair plasma's
    period (omega^2 = 2 omega_pe^2 + 3 k^2 v_th^2) is LANGMUIR_PERIOD_STEPS
    steps; returns (cfg, omega)."""
    cfg = plasma_cfg(3, n, (2, 1, 1), 1, 0.01, "ions", steps)
    omega = 2.0 * math.pi / (LANGMUIR_PERIOD_STEPS * cfg.dt)
    k = 2.0 * math.pi / (cfg.geometry.prob_hi[0] - cfg.geometry.prob_lo[0])
    v_th = 0.01 * C_LIGHT
    wpe2 = 0.5 * (omega ** 2 - 3.0 * k * k * v_th * v_th)
    density = wpe2 * EPS0 * M_E / Q_E ** 2
    species = tuple(dataclasses.replace(s, density=density)
                    for s in cfg.species)
    return dataclasses.replace(
        cfg, species=species, grid_type="collocated", tiled_particles="off",
        field_gathering="momentum-conserving", em_solver=solver,
        current_deposition="direct" if solver == "psatd" else "esirkepov",
        use_filter=False), omega


def seed_langmuir(sim):
    """ux += u0 c sin(k x) on the electrons."""
    geom = sim.cfg.geometry
    sp = sim.state.species["electrons"]
    k = 2.0 * math.pi / (geom.prob_hi[0] - geom.prob_lo[0])
    ux = sp.ux + LANGMUIR_U0 * C_LIGHT * torch.sin(k * (sp.x - geom.prob_lo[0]))
    sim.state = sim.state.replace(species={**sim.state.species,
                                           "electrons": sp.replace(ux=ux)})


def zero_crossing_omega(amp, dt):
    t = np.arange(len(amp)) * dt
    crossings = [t[i] - amp[i] * (t[i + 1] - t[i]) / (amp[i + 1] - amp[i])
                 for i in range(1, len(amp) - 1)
                 if amp[i] != 0 and amp[i] * amp[i + 1] < 0]
    if len(crossings) < 3:
        return float("nan"), len(crossings)
    return (math.pi * (len(crossings) - 1)
            / (crossings[-1] - crossings[0]), len(crossings))


def phase_main_collocated(dev, smi, n=128, nz_qed=2048):
    """main_collocated: ``collocated_langmuir_cfg`` under PSATD (the
    reference's langmuir_multi_psatd_nodal / _momentum_conserving), float32,
    seeded with ux = u0 sin(k x): the x-Fourier amplitude of Ex after every
    step, its frequency from the zero crossings within 2 % of the
    Bohm-Gross frequency over 1.5 periods; ms a step.  The same plasma for
    a few steps under the nodal curls (Yee), ms a step.  Then hybrid QED:
    ``hybrid_qed_deck`` at 64 x ``nz_qed`` in float64 until the pulse has
    travelled QED_TRAVEL: its peak's speed within 1.25 % of c / sqrt((1 +
    12 xi Es^2/eps0) / (1 + 4 xi Es^2/eps0)) and below c (1 - 1e-4)
    (tests/test_hybrid_qed.py:36-50); the float32 run's speed and its pulse
    line's spread from float64's beside it."""
    import warpx_tpu_torch
    from warpx_tpu_torch.utils.parser import Deck

    res = {}
    for solver, steps in (("psatd", LANGMUIR_STEPS), ("yee", 5)):
        cfg, omega = collocated_langmuir_cfg(n, steps, solver)
        sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32,
                                         device=dev)
        sim.init()
        seed_langmuir(sim)
        geom = cfg.geometry
        xc = torch.as_tensor(geom.nodes(0)[:geom.n_cell[0]], device=dev)
        sin_kx = torch.sin(2 * math.pi * (xc - geom.prob_lo[0])
                           / (geom.prob_hi[0] - geom.prob_lo[0]))
        amps = []
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(steps):
            sim.evolve(1)
            amps.append((sim.state.fields.Ex.double().sum(dim=(1, 2))
                         * sin_kx).sum())
        b.record()
        b.synchronize()
        ms_step = a.elapsed_time(b) / steps
        finite = all(bool(torch.isfinite(getattr(sim.state.fields,
                                                 c)).all())
                     for c in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"))
        res[solver] = {"ms_per_step": ms_step, "steps": steps,
                       "finite": finite, "binned": sim.binned}
        if solver == "psatd":
            amp = torch.stack(amps).cpu().numpy()
            w_meas, nc = zero_crossing_omega(np.concatenate([[0.0], amp]),
                                             cfg.dt)
            err = abs(w_meas / omega - 1.0)
            res[solver].update(omega=omega, omega_measured=w_meas,
                               omega_rel_err=err, zero_crossings=nc,
                               density_m3=cfg.species[0].density)
            if not (err <= 0.02 and finite):
                raise AssertionError(f"main_collocated: omega {w_meas} "
                                     f"against {omega} ({nc} crossings)")
        elif not finite:
            raise AssertionError("main_collocated: the nodal curls' run "
                                 "is not finite")
        del sim
        torch.cuda.empty_cache()

    # hybrid QED
    lo_z, hi_z = -80e-6, 120e-6
    xi, es = HYBRID_QED_XI, HYBRID_QED_ES
    g = xi * es * es / EPS0
    v_th = C_LIGHT / math.sqrt((1.0 + 12.0 * g) / (1.0 + 4.0 * g))
    qed, lines = {}, {}
    for dtype in (torch.float64, torch.float32):
        probe = warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(hybrid_qed_deck(64, nz_qed, 1, lo_z, hi_z)),
            dtype=dtype, device=dev)
        steps = int(round(QED_TRAVEL / v_th / probe.cfg.dt))
        del probe
        sim = warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(hybrid_qed_deck(64, nz_qed, steps, lo_z, hi_z)),
            dtype=dtype, device=dev)
        sim.init()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        sim.evolve()
        b.record()
        b.synchronize()
        ey = sim.state.fields.Ey.double().cpu().numpy()
        geom = sim.cfg.geometry
        line = ey[ey.shape[0] // 2, :] - es
        z_end = geom.prob_lo[1] + int(np.argmax(line)) * geom.dx[1]
        v = z_end / float(sim.state.time)
        lines[dtype] = line
        qed[str(dtype).split(".")[-1]] = {
            "steps": steps, "v_over_c": v / C_LIGHT,
            "v_rel_err": abs(v - v_th) / v_th,
            "ms_per_step": a.elapsed_time(b) / steps}
        del sim
    f64 = qed["float64"]
    qed["float32"]["pulse_spread_of_peak"] = float(
        np.abs(lines[torch.float32] - lines[torch.float64]).max()
        / np.abs(lines[torch.float64]).max())
    if not (f64["v_rel_err"] < 0.0125
            and f64["v_over_c"] < 1.0 - 1e-4):
        raise AssertionError(f"main_collocated hybrid QED: {qed}")
    emit("main_collocated", ok=True, n_cell=[n] * 3, langmuir=res["psatd"],
         nodal_yee=res["yee"], omega_tol=0.02,
         hybrid_qed={"n_cell": [64, nz_qed], "xi": xi, "Es_V_m": es,
                     "v_theory_over_c": v_th / C_LIGHT, "tol": 0.0125,
                     **qed},
         nvidia_smi=smi)


BEAMLINE_STEPS = 20
BEAMLINE_PLANE = -12e-6
BEAMLINE_ELEMENTS = (("quad", -11e-6, -5e-6, 3.0e14, 2.0e6),
                     ("plasmalens", -4e-6, 2e-6, 2.0e14, 1.0e6))


def beamline_cfg(n=128, steps=BEAMLINE_STEPS, npart=2 ** 20):
    """A 3D n^3 periodic box of 1 um cells holding a witness beam
    (do_not_deposit) of ``npart`` electrons at uz = 100, rigid-injected at
    BEAMLINE_PLANE, through a hard-edged quadrupole and a plasma lens
    (BEAMLINE_ELEMENTS), per particle (the reference's accelerator_lattice
    example's witness)."""
    from warpx_tpu_torch.core.config import SimConfig, SpeciesConfig
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    half = 0.5e-6 * n
    geom = Geometry(ndim=3, n_cell=(n,) * 3, prob_lo=(-half,) * 3,
                    prob_hi=(half,) * 3, periodic=(True,) * 3)
    beam = SpeciesConfig(
        name="beam", charge=-Q_E, mass=M_E, species_type="electron",
        injection_style="gaussian_beam", x_rms=5e-6, y_rms=5e-6,
        z_rms=3e-6, z_m=-20e-6, npart=npart, q_tot=-1e-12,
        momentum_distribution="gaussian", uz=100.0, ux_th=0.1, uy_th=0.1,
        uz_th=1.0, do_not_deposit=True, zinject_plane=BEAMLINE_PLANE)
    return SimConfig(geometry=geom, max_step=steps,
                     dt=compute_dt_yee(geom, 0.999), species=(beam,),
                     tiled_particles="off",
                     lattice_elements=BEAMLINE_ELEMENTS)


def host_beamline(pos, u, dt, steps, vz_ave, plane):
    """The beam pushed on the host in float64 through the lattice's
    hard-edged fields (the JAX package's core/step.py:40-69: the fraction
    of the step inside each element from z and z + v_z dt) with rigid
    injection (core/step.py:137-175): Boris, then the particles still
    upstream of the plane get their momentum back and advance at vz_ave."""
    x, y, z = (a.copy() for a in pos)
    ux, uy, uz = (a.copy() for a in u)
    q, m = -Q_E, M_E

    def inv_g(ux, uy, uz):
        return 1.0 / np.sqrt(1.0 + (ux * ux + uy * uy + uz * uz)
                             / C_LIGHT ** 2)

    for _ in range(steps):
        zp = z + uz * inv_g(ux, uy, uz) * dt
        zl, zr = np.minimum(z, zp), np.maximum(z, zp)
        same = zr == zl
        ex = np.zeros_like(x)
        ey, bx, by = (np.zeros_like(x) for _ in range(3))
        for kind, zs, ze, dedx, dbdx in BEAMLINE_ELEMENTS:
            frac = np.where(same, ((z >= zs) & (z < ze)).astype(float),
                            (np.clip(zr, zs, ze) - np.clip(zl, zs, ze))
                            / np.where(same, 1.0, zr - zl))
            if kind == "quad":
                ex, ey = ex + x * frac * dedx, ey - y * frac * dedx
                bx, by = bx + y * frac * dbdx, by + x * frac * dbdx
            else:
                ex, ey = ex + x * frac * dedx, ey + y * frac * dedx
                bx, by = bx + y * frac * dbdx, by - x * frac * dbdx
        # rigid: the fields of a particle about to cross scaled by the part
        # of the step past the plane
        dts = 1.0 - (plane - z) / vz_ave / dt
        s = np.where((dts > 0.0) & (dts < 1.0), dts, 1.0)
        e = [ex * s, ey * s, np.zeros_like(x)]
        bb = [bx * s, by * s, np.zeros_like(x)]
        ec = 0.5 * q * dt / m
        vx, vy, vz = ux + ec * e[0], uy + ec * e[1], uz + ec * e[2]
        ig = inv_g(vx, vy, vz)
        t = [ec * ig * c for c in bb]
        tsqi = 2.0 / (1.0 + t[0] ** 2 + t[1] ** 2 + t[2] ** 2)
        sx, sy, sz = (c * tsqi for c in t)
        px = vx + vy * t[2] - vz * t[1]
        py = vy + vz * t[0] - vx * t[2]
        pz = vz + vx * t[1] - vy * t[0]
        vx, vy, vz = vx + py * sz - pz * sy, vy + pz * sx - px * sz, \
            vz + px * sy - py * sx
        nux, nuy, nuz = vx + ec * e[0], vy + ec * e[1], vz + ec * e[2]
        ig = inv_g(nux, nuy, nuz)
        nx, ny, nz = x + nux * ig * dt, y + nuy * ig * dt, z + nuz * ig * dt
        up = nz <= plane
        ux, uy, uz = (np.where(up, o, nw) for o, nw in
                      ((ux, nux), (uy, nuy), (uz, nuz)))
        x, y = np.where(up, x, nx), np.where(up, y, ny)
        z = np.where(up, z + dt * vz_ave, nz)
    return (x, y, z), (ux, uy, uz)


def phase_main_beamline(dev, smi, n=128):
    """main_beamline: ``beamline_cfg`` (2^20 electrons) per particle,
    float32, BEAMLINE_STEPS steps: the particles still upstream of the plane
    at the end kept their momenta bitwise and advanced by steps dt vz_ave;
    every transverse momentum within 1e-5 of the largest of a float64 host
    push through the same hard-edged fields (``host_beamline``); ms a
    step."""
    import warpx_tpu_torch

    cfg = beamline_cfg(n)
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    sim.init()
    sp0 = sim.state.species["beam"]
    alive = sp0.alive.cpu().numpy()
    pos0 = [p.cpu().numpy() for p in sp0.positions(3)]
    u0 = [getattr(sp0, c).cpu().numpy() for c in ("ux", "uy", "uz")]
    vz_ave = float(sim.state.aux["vzave:beam"])
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    sim.evolve()
    b.record()
    b.synchronize()
    ms_step = a.elapsed_time(b) / cfg.max_step
    sp = sim.state.species["beam"]
    pos = [p.cpu().numpy() for p in sp.positions(3)]
    u = [getattr(sp, c).cpu().numpy() for c in ("ux", "uy", "uz")]
    up = alive & (pos[2] <= BEAMLINE_PLANE)
    crossed = alive & ~up
    same_u = all(np.array_equal(a_[up], b_[up]) for a_, b_ in zip(u, u0))
    # the float32 sum of ``steps`` equal advances toward z = 0: each rounds
    # by at most half a unit in the last place of the starting z
    z_rigid = pos0[2][up].astype(np.float64) + cfg.max_step * cfg.dt * vz_ave
    z_err = float((np.abs(pos[2][up] - z_rigid)
                   / (cfg.max_step * np.spacing(np.abs(pos0[2][up])))).max())
    hpos, hu = host_beamline([p[alive].astype(np.float64) for p in pos0],
                             [c[alive].astype(np.float64) for c in u0],
                             cfg.dt, cfg.max_step, vz_ave, BEAMLINE_PLANE)
    scale = max(float(np.abs(hu[0]).max()), float(np.abs(hu[1]).max()))
    u_err = max(float(np.abs(u[i][alive] - hu[i]).max()) for i in (0, 1))
    kick = max(float(np.abs(hu[i] - u0[i][alive]).max()) for i in (0, 1))
    if not (same_u and z_err <= 1.0 and up.sum() > 0 and crossed.sum() > 0
            and u_err <= 1e-5 * scale and kick > 0.01 * scale):
        raise AssertionError(f"main_beamline: upstream u unchanged "
                             f"{same_u}, z off by {z_err}, {int(up.sum())} "
                             f"upstream, {int(crossed.sum())} crossed, "
                             f"transverse u off by {u_err} of {scale}, "
                             f"kick {kick}")
    emit("main_beamline", ok=True, n_cell=[n] * 3, particles=int(alive.sum()),
         steps=cfg.max_step, dtype="float32", plane_m=BEAMLINE_PLANE,
         elements=[list(e) for e in BEAMLINE_ELEMENTS],
         upstream=int(up.sum()), crossed=int(crossed.sum()),
         upstream_z_err_of_steps_ulp=z_err, transverse_u_max_abs_err=u_err,
         transverse_u_scale=scale, transverse_kick=kick,
         ms_per_step=ms_step, nvidia_smi=smi)
    del sim


LWFA_WARM_PLAN = dict(warm=4, timed=8, counted=2, interval=16)
LWFA_WARM_U_TH = 0.01


def phase_main_lwfa_warm(dev, smi, k1c_row, k3_row, cold_ms, nx=2048,
                         nz=8192):
    """lwfa2d-2048x8192-warm: main_lwfa_deck's deck at 'mixed' whose
    electrons (the initial ones and the continuously injected ones) take
    Gaussian momenta of spread LWFA_WARM_U_TH, driven as main_lwfa is
    (``run_lwfa_path``: zero overflow and violations, finite fields, the
    alive electrons explained by the rows absorbed and injected); every
    injection counted: their total equals the rows the window uncovered
    times a row's electrons, and the injected electrons' mean and rms of
    each momentum component lie within 3 standard errors of the deck's; ms
    a step beside main_lwfa_deck's cold run (``cold_ms``); adds the
    launches to K1c's ('mixed') and K3's rows."""
    import warpx_tpu_torch
    from warpx_tpu_torch.core import bounded_step as bs_mod
    from warpx_tpu_torch.utils.parser import Deck

    steps = lwfa_steps(LWFA_WARM_PLAN)
    text = lwfa_deck_text(nx, nz, steps, "mixed").replace(
        "electrons.momentum_distribution_type = at_rest",
        "electrons.momentum_distribution_type = gaussian\n"
        + "".join(f"electrons.u{c}_th = {LWFA_WARM_U_TH}\n" for c in "xyz"))
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float32, device=dev)
    injected = []
    orig = bs_mod.BoundedStepper.continuous_injection

    def counted(self, state, sp_cfg, sp, *a, **kw):
        st, new = orig(self, state, sp_cfg, sp, *a, **kw)
        injected.append(int(new.alive.sum()) - int(sp.alive.sum()))
        return st, new

    row0 = {}

    def top_row(s):
        el = s.state.species["electrons"]
        g = s.cfg.geometry
        row0["n"] = int((el.alive & (el.z >= g.prob_hi[1] - g.dx[1])).sum())

    bs_mod.BoundedStepper.continuous_injection = counted
    try:
        launches, _, _, waits = run_lwfa_path(dev, smi, "main_lwfa_warm",
                                              sim, LWFA_WARM_PLAN,
                                              on_init=top_row)
    finally:
        bs_mod.BoundedStepper.continuous_injection = orig
    geom = sim.cfg.geometry
    rows_in = round((float(sim.state.aux["inject_pos:electrons"])
                     - geom.prob_hi[1]) / geom.dx[1])
    if not (sum(injected) == rows_in * row0["n"] and rows_in > 0):
        raise AssertionError(f"main_lwfa_warm: {sum(injected)} injected in "
                             f"{len(injected)} calls, {rows_in} rows of "
                             f"{row0['n']}")
    el = sim.state.species["electrons"]
    # injected above the window's first top edge and ahead of the laser's
    # front (which reaches no injected cell at full width in these steps)
    front = (sim.cfg.lasers[0].position[2]
             + C_LIGHT * float(sim.state.time))
    new = el.alive & (el.z > max(geom.prob_hi[1], front) + geom.dx[1])
    nn = int(new.sum())
    moments = {}
    for c in "xyz":
        v = getattr(el, "u" + c)[new].double() / C_LIGHT
        mean, std = float(v.mean()), float(v.std())
        moments[c] = {"mean": mean, "rms": std}
        if not (abs(mean) < 3.0 * LWFA_WARM_U_TH / math.sqrt(nn)
                and abs(std - LWFA_WARM_U_TH)
                < 3.0 * LWFA_WARM_U_TH / math.sqrt(2.0 * nn)):
            raise AssertionError(f"main_lwfa_warm: injected u{c} mean "
                                 f"{mean}, rms {std} over {nn}")
    emit("main_lwfa_warm_injection", ok=True, injected=sum(injected),
         injections=len(injected), rows_injected=rows_in,
         row_electrons=row0["n"], moments=moments, sampled=nn,
         u_th=LWFA_WARM_U_TH, ms_per_step=waits["ms_per_step"],
         cold_ms_per_step=cold_ms, nvidia_smi=smi)
    add_launches({"fused_pic_moving_window_mixed": k1c_row,
                  "ragged_expand": k3_row},
                 {"fused_pic_moving_window_mixed": launches["fused_pic_2d"],
                  "ragged_expand": launches["ragged_expand"]},
                 "main_lwfa_warm")


# ---- 1D Cartesian geometry and the runtime attributes (Queue A 3-4, 11.6)

def kernel_counters():
    """(K1, K2, K3) launch counters: K1 3D, K2 2D (K1c in the bounded
    frame), K3 the rebin's expansion."""
    from warpx_tpu_torch.ops import fused_pic as fp
    from warpx_tpu_torch.ops import tiling

    return (fp.binned_push_deposit.launches,
            fp.binned_push_deposit.launches_2d, tiling.ragged_expand.launches)


DIMS1_PERIODIC_DECK = """
max_step = 4
amr.n_cell = 64
geometry.dims = 1
geometry.prob_lo = -10.e-6
geometry.prob_hi = 10.e-6
warpx.cfl = 0.8
algo.particle_shape = {order}
algo.current_deposition = {dep}
algo.maxwell_solver = {solver}
particles.species_names = electrons ions
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 2
electrons.profile = constant
electrons.density = 1.e25
electrons.momentum_distribution_type = parse_momentum_function
electrons.momentum_function_ux(x,y,z) = 0.01*sin(z*3.e5)
electrons.momentum_function_uy(x,y,z) = 0.02*cos(z*3.e5)
electrons.momentum_function_uz(x,y,z) = 0.05*sin(z*3.14159e5)
ions.species_type = proton
ions.injection_style = NUniformPerCell
ions.num_particles_per_cell_each_dim = 1
ions.profile = constant
ions.density = 1.e25
ions.momentum_distribution_type = constant
ions.uz = 0.001
"""

# WarpX's inputs_test_1d_laser_acceleration in form (tests/test_langmuir.py
# :51-66): a window at c, PEC faces, a Gaussian antenna at 0.8 um, CKC, the
# bilinear filter, order 3, continuous injection, an integer
# regionofinterest and a real initialenergy attribute
LWFA_1D_DECK = """
max_step = {steps}
amr.n_cell = {n}
geometry.dims = 1
geometry.prob_lo = {lo}
geometry.prob_hi = {hi}
boundary.field_lo = {faces}
boundary.field_hi = {faces}
warpx.cfl = 0.9
warpx.do_moving_window = 1
warpx.moving_window_dir = z
warpx.moving_window_v = 1.0
warpx.use_filter = 1
algo.maxwell_solver = ckc
algo.particle_shape = 3
particles.species_names = electrons
electrons.charge = -q_e
electrons.mass = m_e
electrons.injection_style = "NUniformPerCell"
electrons.num_particles_per_cell_each_dim = {ppc}
electrons.xmin = -20.e-6
electrons.xmax = 20.e-6
electrons.ymin = -20.e-6
electrons.ymax = 20.e-6
electrons.zmin = {zmin}
electrons.profile = constant
electrons.density = 2.e23
electrons.momentum_distribution_type = "at_rest"
electrons.do_continuous_injection = 1
electrons.addIntegerAttributes = regionofinterest
electrons.attribute.regionofinterest(x,y,z,ux,uy,uz,t) = "(z>12.0e-6) * (z<13.0e-6)"
electrons.addRealAttributes = initialenergy
electrons.attribute.initialenergy(x,y,z,ux,uy,uz,t) = " ux*ux + uy*uy + uz*uz"
lasers.names = laser1
laser1.profile = Gaussian
laser1.position = 0. 0. {laser_z}
laser1.direction = 0. 0. 1.
laser1.polarization = 0. 1. 0.
laser1.e_max = 16.e12
laser1.profile_waist = 5.e-6
laser1.profile_duration = 15.e-15
laser1.profile_t_peak = 30.e-15
laser1.profile_focal_distance = 100.e-6
laser1.wavelength = 0.8e-6
"""


def lwfa_1d_deck(steps, n=4096, ppc=256, faces="pec", lo=-92.4e-6,
                 hi=10.e-6, zmin=-10.e-6, laser_z=-20.e-6):
    return LWFA_1D_DECK.format(steps=steps, n=n, ppc=ppc, faces=faces,
                               lo=lo, hi=hi, zmin=zmin, laser_z=laser_z)


# A 11.6 on the tile-binned steps: 9216 electrons (above the 8192 below
# which a species keeps its compact layout) with an integer and two real
# attributes, periodic (K2, K3) and under a moving window with continuous
# injection (K2 in moving-window mode, K3)
ATTR_BINNED_DECK = """
max_step = 4
amr.n_cell = 32 32
geometry.dims = 2
geometry.prob_lo = -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6
warpx.sort_intervals = 2
algo.particle_shape = 2
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 3 3
electrons.profile = constant
electrons.density = 1.e24
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.01
electrons.uy_th = 0.01
electrons.uz_th = 0.01
electrons.addIntegerAttributes = roi
electrons.attribute.roi(x,y,z,ux,uy,uz,t) = "(z>-2.0e-6) * (z<3.0e-6) + 3*(x>0)"
electrons.addRealAttributes = e0 orig_z
electrons.attribute.e0(x,y,z,ux,uy,uz,t) = "ux*ux + uy*uy + uz*uz"
electrons.attribute.orig_z(x,y,z,ux,uy,uz,t) = "z"
tpu.tiled_particles = on
"""

ATTR_WINDOW_DECK = """
max_step = 8
amr.n_cell = 16 64
geometry.dims = 2
geometry.prob_lo = -8.e-6 -24.e-6
geometry.prob_hi =  8.e-6   8.e-6
boundary.field_lo = pec pml
boundary.field_hi = pec pml
warpx.cfl = 0.98
warpx.do_moving_window = 1
warpx.moving_window_dir = z
warpx.moving_window_v = 1.0
warpx.sort_intervals = 4
algo.particle_shape = 2
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 2
electrons.xmin = -6.e-6
electrons.xmax =  6.e-6
electrons.zmin = -20.e-6
electrons.profile = parse_density_function
electrons.density_function(x,y,z) = "2.e23*(1+0.5*sin(z*1.e6))"
electrons.momentum_distribution_type = constant
electrons.ux = 0.01
electrons.uz = 0.02
electrons.do_continuous_injection = 1
electrons.addIntegerAttributes = roi
electrons.attribute.roi(x,y,z,ux,uy,uz,t) = "(z>4.e-6) + 2*(x>0)"
electrons.addRealAttributes = t0
electrons.attribute.t0(x,y,z,ux,uy,uz,t) = "t*1.e15 + uz*1.e-8"
tpu.tiled_particles = on
"""

# a boosted Gaussian beam propagating backward (do_backward_propagation)
# with attributes, in a periodic 2D box at gamma_boost = 10, per particle
BACKWARD_BEAM_DECK = """
max_step = 4
amr.n_cell = 32 64
geometry.dims = 2
geometry.prob_lo = -16.e-6 -40.e-6
geometry.prob_hi =  16.e-6  40.e-6
warpx.gamma_boost = 10.
warpx.boost_direction = z
algo.particle_shape = 2
particles.species_names = beam
beam.species_type = electron
beam.injection_style = gaussian_beam
beam.x_rms = 2.e-6
beam.y_rms = 2.e-6
beam.z_rms = 4.e-6
beam.z_m = 0.
beam.npart = 4000
beam.q_tot = -1.e-10
beam.momentum_distribution_type = gaussian
beam.uz_m = 200.
beam.ux_th = 0.5
beam.uy_th = 0.5
beam.uz_th = 5.
beam.do_backward_propagation = 1
beam.addRealAttributes = z0
beam.attribute.z0(x,y,z,ux,uy,uz,t) = "z"
beam.addIntegerAttributes = up
beam.attribute.up(x,y,z,ux,uy,uz,t) = "uz > 0"
tpu.tiled_particles = off
"""


def dims1_parity_cases():
    """(name, deck text, tile-binned?) of dims1_parity."""
    cases = []
    for dep in ("esirkepov", "direct", "villasenor"):
        for order, solver in ((1, "yee"), (2, "ckc"), (3, "yee")):
            cases.append((f"periodic_{dep}_{order}_{solver}",
                          DIMS1_PERIODIC_DECK.format(dep=dep, order=order,
                                                     solver=solver), False))
    base = DIMS1_PERIODIC_DECK.format(dep="esirkepov", order=2, solver="yee")
    cases += [
        ("periodic_collocated", base + "warpx.grid_type = collocated\n",
         False),
        ("periodic_psatd", base.replace("maxwell_solver = yee",
                                        "maxwell_solver = psatd"), False),
        ("periodic_electrostatic", base + "warpx.do_electrostatic = "
         "labframe\nwarpx.use_filter = 0\n", False),
    ]
    small = dict(n=128, ppc=4, lo=-30e-6, hi=2e-6, zmin=-5e-6,
                 laser_z=-8e-6)
    cases.append(("lwfa_pec_window", lwfa_1d_deck(20, **small), False))
    for faces in ("pml", "absorbing_silver_mueller"):
        text = "\n".join(ln for ln in lwfa_1d_deck(
            20, faces=faces, **small).splitlines()
            if "moving_window" not in ln and "continuous" not in ln)
        cases.append((f"antenna_{faces}", text, False))
    cases += [("attributes_2d_binned", ATTR_BINNED_DECK, True),
              ("attributes_2d_window_binned", ATTR_WINDOW_DECK, True),
              ("backward_beam_2d_boosted", BACKWARD_BEAM_DECK, False)]
    return cases


def phase_dims1_parity(dev):
    """dims1_parity: 1D Cartesian geometry and the runtime attributes in
    float64, card against CPU on the same numbers: the periodic 1D step
    under Esirkepov, direct and villasenor deposition at orders 1-3 (Yee
    and CKC), on a collocated grid, under PSATD and under the lab-frame
    electrostatic solve; the 1D laser-wakefield deck (window, PEC, antenna,
    filter, continuous injection, an integer and a real attribute) and the
    antenna's pulse through PML and Silver-Mueller faces; the attributes
    through the tile-binned 2D steps (periodic: K2 and K3 with three
    attribute rows; under a moving window: K2 in moving-window mode and K3,
    the attributes injected continuously); a boosted Gaussian beam with
    do_backward_propagation.  Fields and species (the integer attributes
    exactly) within 1e-12 of their largest values per particle, 1e-9
    tile-binned, checksums within 1e-9; no 1D case launches a kernel, each
    binned case launches K2 and K3.  Returns the binned cases' K2 and K3
    launches (not the main paths'): K2 periodic, K2 in the bounded frame
    (the K1c row) and K3."""
    out = {}
    counts = {"fused_pic_2d": 0, "fused_pic_2d_window": 0,
              "ragged_expand": 0}
    for name, text, binned in dims1_parity_cases():
        before = kernel_counters()
        t0 = time.perf_counter()
        card = stochastic_run(text, dev, torch.float64)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        k1_n, k2_n, k3_n = (a - b for a, b in zip(kernel_counters(), before))
        t0 = time.perf_counter()
        cpu = stochastic_run(text, "cpu", torch.float64)
        cpu_s = time.perf_counter() - t0
        if card.binned != binned or bool(k1_n or k2_n or k3_n) != binned or (
                binned and not (k2_n and k3_n)):
            raise AssertionError(f"dims1_parity {name}: binned {card.binned},"
                                 f" K1 {k1_n}, K2 {k2_n}, K3 {k3_n}")
        tol = 1e-9 if binned else 1e-12
        worst = states_agree(card, cpu, tol, f"dims1_parity {name}")
        worst_sum = checksums_agree(card.checksums(), cpu.checksums(), 1e-9,
                                    f"dims1_parity {name}")
        extra = {nm: sorted(sp.extra) for nm, sp in card.state.species.items()
                 if sp.extra}
        for nm, sp in card.state.species.items():
            for k, v in sp.extra.items():
                if k in ("roi", "regionofinterest", "up") and (
                        v.dtype != torch.int32):
                    raise AssertionError(f"dims1_parity {name}: {nm}.{k} is "
                                         f"{v.dtype}")
        counts["fused_pic_2d_window" if card.is_bounded
               else "fused_pic_2d"] += k2_n
        counts["ragged_expand"] += k3_n
        out[name] = {"ndim": card.cfg.geometry.ndim, "tol": tol,
                     "max_rel_err": worst, "checksum_max_rel_err": worst_sum,
                     "binned": binned, "k2_launches": k2_n,
                     "k3_launches": k3_n, "attributes": extra,
                     "alive": {nm: int(sp.alive.sum())
                               for nm, sp in card.state.species.items()},
                     "card_s": card_s, "cpu_s": cpu_s}
    emit("dims1_parity", ok=True, cases=out)
    return counts


MAIN_1D_PERIOD_STEPS = 24
MAIN_1D_U0 = 0.05
TOL_MAIN_1D_OMEGA = 0.02


def main_1d_cfg(n=1048576, ppc=16, steps=40):
    """uniform1d-1M: a periodic 1D thermal electron plasma (u_th 0.01) of n
    cells of 0.1 um, ``ppc`` electrons a cell, order 3, Esirkepov, Yee at
    cfl 0.999, no filter, its density chosen so that the plasma period is
    MAIN_1D_PERIOD_STEPS steps; returns (cfg, Bohm-Gross omega at the
    box's longest mode)."""
    from warpx_tpu_torch.core.deck import config_from_deck
    from warpx_tpu_torch.utils.parser import Deck

    dz = 1e-7
    text = f"""
max_step = {steps}
amr.n_cell = {n}
geometry.dims = 1
geometry.prob_lo = 0.
geometry.prob_hi = {n * dz}
warpx.cfl = 0.999
warpx.use_filter = 0
algo.particle_shape = 3
algo.current_deposition = esirkepov
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = {ppc}
electrons.profile = constant
electrons.density = 1.e25
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.01
electrons.uy_th = 0.01
electrons.uz_th = 0.01
"""
    cfg = config_from_deck(Deck.from_string(text))
    omega = 2.0 * math.pi / (MAIN_1D_PERIOD_STEPS * cfg.dt)
    k = 2.0 * math.pi / (n * dz)
    v_th = 0.01 * C_LIGHT
    wpe2 = omega ** 2 - 3.0 * k * k * v_th * v_th
    density = wpe2 * EPS0 * M_E / Q_E ** 2
    cfg = dataclasses.replace(cfg, species=tuple(
        dataclasses.replace(s, density=density) for s in cfg.species))
    return cfg, omega


def run_main_1d(dev, cfg, omega, dtype, steps):
    """One run of uniform1d-1M in ``dtype``: init, the seed uz += u0 c
    sin(k z), ``steps`` - 2 timed steps sampling the Fourier amplitude of
    Ez, one profiled step, the closing step.  Returns the phase's numbers
    (the frequency from the amplitude's zero crossings)."""
    import warpx_tpu_torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = warpx_tpu_torch.Simulation(cfg, dtype=dtype, device=dev)
    if sim.binned or sim.is_bounded:
        raise AssertionError("main_1d left the periodic per-particle step")
    sim.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    geom = cfg.geometry
    sp = sim.state.species["electrons"]
    k = 2.0 * math.pi / (geom.prob_hi[0] - geom.prob_lo[0])
    sim.state = sim.state.replace(species={"electrons": sp.replace(
        uz=sp.uz + MAIN_1D_U0 * C_LIGHT * torch.sin(k * sp.z))})
    n_part = int(sp.alive.sum())
    w0 = float(sp.w.double().sum())
    sin_kz = torch.sin(k * torch.as_tensor(geom.cell_centers(0), device=dev))
    amps = []
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(steps - 2):
        sim.evolve(1)
        amps.append((sim.state.fields.Ez.double() * sin_kz).sum())
    b.record()
    b.synchronize()
    ms_step = a.elapsed_time(b) / (steps - 2)
    breakdown = profile_steps(sim, 1)
    sim.evolve()  # the closing step, with the +dt/2 synchronization
    torch.cuda.synchronize()
    amp = torch.stack(amps).cpu().numpy()
    w_meas, nc = zero_crossing_omega(np.concatenate([[0.0], amp]), cfg.dt)
    sp = sim.state.species["electrons"]
    out = {"steps": sim.state.step, "ms_per_step": ms_step,
           "pushes_per_s": n_part / (ms_step * 1e-3), "init_s": init_s,
           "omega_measured": w_meas, "omega_rel_err": abs(w_meas / omega
                                                           - 1.0),
           "zero_crossings": nc, "n_particles": n_part,
           "alive": int(sp.alive.sum()),
           "weight_rel_err": abs(float(sp.w.double().sum()) / w0 - 1.0),
           "finite": all(bool(torch.isfinite(getattr(sim.state.fields,
                                                     c)).all())
                         for c in ("Ex", "Ey", "Ez", "Bx", "By", "Bz")),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "device_busy_share": breakdown["device_busy_share"],
           "device_ms_per_step": breakdown["device_ms_per_step"]}
    del sim
    torch.cuda.empty_cache()
    return out, breakdown


def phase_main_1d(dev, smi, n=1048576, ppc=16, steps=40):
    """uniform1d-1M (``main_1d_cfg``), per particle (the JAX package's 1D
    is per particle; no kernel), in float64 and in float32: seeded with uz
    += u0 c sin(k z) at the box's longest mode, the Fourier amplitude of
    Ez after every step (CUDA events around the steps), its frequency from
    the zero crossings (as main_collocated measures it).  In float64 the
    frequency within TOL_MAIN_1D_OMEGA of Bohm-Gross, the weight kept to
    1e-6, every electron alive, finite fields and no kernel launched; ms a
    step, pushes a second, the device's busy share over one profiled step.
    The float32 run is reported beside it: at 0.1 m from the origin a
    float32 position resolves 7.5e-9 m, 0.075 cells, more than a thermal
    electron moves in a step (0.01 cells), so its far cells do not move."""
    cfg, omega = main_1d_cfg(n, ppc, steps)
    before = kernel_counters()
    runs, profiles = {}, {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        runs[name], profiles[name] = run_main_1d(dev, cfg, omega, dtype,
                                                 steps)
    launched = [a_ - b_ for a_, b_ in zip(kernel_counters(), before)]
    f64 = runs["float64"]
    if not (f64["omega_rel_err"] <= TOL_MAIN_1D_OMEGA
            and f64["alive"] == f64["n_particles"]
            and f64["weight_rel_err"] <= 1e-6 and f64["finite"]
            and not any(launched)):
        raise AssertionError(f"main_1d: {f64}, omega {omega}, kernels "
                             f"launched {launched}")
    emit("main_1d", ok=True, n_cell=cfg.geometry.n_cell,
         order=cfg.particle_shape, steps_timed=steps - 2, omega=omega,
         omega_tol=TOL_MAIN_1D_OMEGA, density_m3=cfg.species[0].density,
         kernel_launches=launched, **f64, float32=runs["float32"],
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    emit("main_1d_profile", steps=1, **profiles["float64"])


# the pulse's peak leaves the antenna at step ~400 and the injection front
# passes 13 um at step ~134; the per-particle bounded step is host-bound
# (some 1900 launches a step)
MAIN_LWFA_1D_STEPS = 450
TOL_LWFA_1D_PEAK = 0.05


def phase_main_lwfa_1d(dev, smi, steps=MAIN_LWFA_1D_STEPS, ppc=256):
    """lwfa1d-4096: ``lwfa_1d_deck`` at dz = lambda/32 over a 102.4 um
    window (4096 cells), 256 electrons a cell, float32, ``steps`` steps
    (per particle, no kernel): the antenna's pulse peak |Ey| (max over the
    grid, sampled every step while its peak is emitted, before it reaches
    the plasma) within TOL_LWFA_1D_PEAK of e_max; the alive electrons
    exactly the lattice the window has uncovered above zmin (none left);
    regionofinterest (int32) 1 on exactly the 256 a cell injected in
    (12, 13) um; initialenergy bitwise 0.0 as injected at rest; ms a step,
    pushes a second and the busy share."""
    import warpx_tpu_torch
    from warpx_tpu_torch.utils.parser import Deck

    text = lwfa_1d_deck(steps, ppc=ppc)
    before = kernel_counters()
    t0 = time.perf_counter()
    sim = warpx_tpu_torch.Simulation.from_deck(Deck.from_string(text),
                                               dtype=torch.float32,
                                               device=dev)
    sim.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = sim.cfg
    las = cfg.lasers[0]
    # the pulse peak leaves the antenna at t_peak; sample around it
    k_peak = int(round(las.profile_t_peak / cfg.dt))
    sample = range(k_peak - 40, k_peak + 41)
    peaks = []
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for s in range(1, steps):
        sim.evolve(1)
        if s in sample:
            peaks.append(sim.state.fields.Ey.abs().max())
    b.record()
    b.synchronize()
    ms_step = a.elapsed_time(b) / (steps - 1)
    breakdown = profile_steps(sim, 1)
    torch.cuda.synchronize()
    peak = float(torch.stack(peaks).max())
    peak_rel = abs(peak / las.e_max - 1.0)
    sp = sim.state.species["electrons"]
    alive = int(sp.alive.sum())
    dz = cfg.geometry.dx[0]
    zmin = cfg.species[0].bounds_lo[0]
    front = float(sim.state.aux["inject_pos:electrons"])
    ppc = cfg.species[0].num_particles_per_cell_each_dim[0]
    expect = int(round((front - zmin) / dz)) * ppc
    roi = sp.extra["regionofinterest"]
    n_roi = int((roi[sp.alive] == 1).sum())
    expect_roi = int(round(1e-6 / dz)) * ppc
    energy0 = bool((sp.extra["initialenergy"][sp.alive] == 0.0).all())
    lo = float(sim.state.aux["window_lo"])
    launched = [a_ - b_ for a_, b_ in zip(kernel_counters(), before)]
    finite = all(bool(torch.isfinite(getattr(sim.state.fields, c)).all())
                 for c in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"))
    ok = (peak_rel <= TOL_LWFA_1D_PEAK and alive == expect
          and n_roi == expect_roi and roi.dtype == torch.int32 and energy0
          and finite and not any(launched) and lo < zmin)
    if not ok:
        raise AssertionError(
            f"main_lwfa_1d: peak {peak} against {las.e_max}, alive {alive} "
            f"against {expect}, roi {n_roi} against {expect_roi} "
            f"({roi.dtype}), initialenergy 0 {energy0}, finite {finite}, "
            f"window lo {lo}, kernels {launched}")
    emit("main_lwfa_1d", ok=True, n_cell=cfg.geometry.n_cell,
         dz_over_lambda=dz / las.wavelength, ppc=ppc, dtype="float32",
         steps=sim.state.step, ms_per_step=ms_step,
         pushes_per_s=alive / (ms_step * 1e-3), n_alive=alive,
         expected_alive=expect, init_s=init_s, peak_Ey_V_m=peak,
         e_max_V_m=las.e_max, peak_rel_err=peak_rel,
         peak_tol=TOL_LWFA_1D_PEAK, roi_count=n_roi,
         expected_roi_count=expect_roi,
         window_offset=int(sim.state.aux["window_offset"]),
         injection_front_m=front, kernel_launches=launched,
         device_busy_share=breakdown["device_busy_share"],
         device_ms_per_step=breakdown["device_ms_per_step"],
         nvidia_smi=smi)
    emit("main_lwfa_1d_profile", steps=1, **breakdown)
    del sim
    torch.cuda.empty_cache()


# ---- mesh refinement (Queue A 12.1-12.2) ------------------------------------

# tests/test_torch_mr.py's periodic deck (copied: this script imports no
# test), 32^2 or 16^3 with a ratio-2 patch over the central half of each
# axis
MR_PERIODIC_DECK = """
max_step = {steps}
amr.n_cell = {cells}
amr.max_level = 1
amr.ref_ratio = 2
geometry.dims = {dims}
geometry.prob_lo = {lo}
geometry.prob_hi = {hi}
warpx.fine_tag_lo = {tag_lo}
warpx.fine_tag_hi = {tag_hi}
warpx.cfl = 0.9
warpx.use_filter = 1
algo.particle_shape = {order}
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = {ppc}
electrons.profile = constant
electrons.density = 1.e25
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.05
electrons.uy_th = 0.05
electrons.uz_th = 0.05
"""
# tests/test_torch_mr_bounded.py's patch on the 32 x 64 laser-wakefield deck
MR_WINDOW_KEYS = """
amr.max_level = 1
amr.ref_ratio = 2
warpx.fine_tag_lo = -7.5e-6 -17.e-6
warpx.fine_tag_hi = 7.5e-6 -5.e-6
warpx.refine_plasma = 1
tpu.tiled_particles = off
"""


def mr_parity_cases():
    """(name, deck text) of mr_parity."""
    def deck2d(order=1, steps=4, extra=""):
        return MR_PERIODIC_DECK.format(
            steps=steps, cells="32 32", dims=2, lo="-20.e-6 -20.e-6",
            hi="20.e-6 20.e-6", tag_lo="-8.e-6 -8.e-6",
            tag_hi="8.e-6 8.e-6", order=order, ppc="2 2 2") + extra

    return [
        ("periodic_2d", deck2d()),
        ("periodic_3d", MR_PERIODIC_DECK.format(
            steps=3, cells="16 16 16", dims=3, lo="-8.e-6 -8.e-6 -8.e-6",
            hi="8.e-6 8.e-6 8.e-6", tag_lo="-4.e-6 -4.e-6 -4.e-6",
            tag_hi="4.e-6 4.e-6 4.e-6", order=1, ppc="1 1 1")),
        ("subcycled", deck2d(extra="warpx.do_subcycling = 1\n")),
        ("nci_subcycled", deck2d(order=3, steps=3, extra=(
            "warpx.do_subcycling = 1\nwarpx.use_fdtd_nci_corr = 1\n"))),
        ("momentum_conserving", deck2d(order=2, extra=(
            "algo.field_gathering = momentum-conserving\n"))),
        ("window_pml_refine", LWFA_32X64_DECK + MR_WINDOW_KEYS),
    ]


def phase_mr_parity(dev):
    """mr_parity: mesh refinement in float64, card against CPU on the same
    numbers (the decks of tests/test_torch_mr.py and
    test_torch_mr_bounded.py, which hold the port to the JAX package):
    periodic 2D and 3D, subcycled, subcycled under the NCI corrector,
    momentum-conserving gathering, and the bounded 32 x 64 laser-wakefield
    deck with a patch riding the moving window, PML and refine_plasma.
    Fields, species, the patch's state within 1e-9 of their largest
    values, checksums (lev=0 and lev=1) within 1e-9; MR runs per particle,
    so no kernel is launched."""
    out = {}
    for name, text in mr_parity_cases():
        before = kernel_counters()
        t0 = time.perf_counter()
        card = stochastic_run(text, dev, torch.float64)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launched = [a - b for a, b in zip(kernel_counters(), before)]
        cpu = stochastic_run(text, "cpu", torch.float64)
        if card.mr_layout is None or card.binned or any(launched):
            raise AssertionError(f"mr_parity {name}: MR {card.mr_layout}, "
                                 f"binned {card.binned}, kernels {launched}")
        worst = states_agree(card, cpu, 1e-9, f"mr_parity {name}")
        worst_patch = 0.0
        for k, v in cpu.state.aux.items():
            if k.startswith("mr:"):
                _, rel = rel_err(card.state.aux[k].cpu(), v)
                worst_patch = max(worst_patch, rel)
                if not rel <= 1e-9:
                    raise AssertionError(f"mr_parity {name}: {k} differs by "
                                         f"{rel}")
        sums = card.checksums()
        if "lev=1" not in sums:
            raise AssertionError(f"mr_parity {name}: no lev=1 checksums")
        worst_sum = checksums_agree(sums, cpu.checksums(), 1e-9,
                                    f"mr_parity {name}")
        out[name] = {"max_rel_err": worst, "patch_max_rel_err": worst_patch,
                     "checksum_max_rel_err": worst_sum,
                     "bounded": card.is_bounded,
                     "subcycled": card.cfg.do_subcycling,
                     "patch_cells": card.mr_layout.nc,
                     "alive": {nm: int(sp.alive.sum())
                               for nm, sp in card.state.species.items()},
                     "card_s": card_s}
    emit("mr_parity", ok=True, tol=1e-9, kernel_launches=0, cases=out)


def mr_patch_ms(sim):
    """Each piece of the patch's work alone on the run's state, CUDA events
    over three calls: aux(1) (the interpolation of level 0 into the fine
    patch), the fine and the coarse patch advances (B, E, B with their
    split-field PML), the average-down of the fine J."""
    from warpx_tpu_torch.core import mr as mr_mod
    from warpx_tpu_torch.core.step import _field_dict

    state = sim.state
    layout = sim.mr_layout
    stag = sim.staggering
    cfg = sim.cfg
    if sim.is_bounded:
        stepper = sim.stepper
        adv = stepper.mr.adv

        def aux1():
            return stepper.mr_gather_fields(state)
    else:
        adv = {fine: mr_mod.make_patch_advance(
            layout, stag, cfg.em_solver, 0.5 * cfg.dt, cfg.dt, fine,
            sim.dtype, sim.device) for fine in (True, False)}

        def aux1():
            return mr_mod.compute_aux1(_field_dict(state.fields), state.aux,
                                       layout, stag)
    jf = tuple(state.aux[f"mr:j:{nm}"] for nm in ("jx", "jy", "jz"))
    out = {"aux1_ms": cuda_ms(aux1, 3)}
    for fine, tag in ((True, "f"), (False, "c")):
        b, e = adv[fine]
        parts = mr_mod.patch_parts(state.aux, tag)
        j3 = jf if fine else tuple(mr_mod.coarsen_field(a, stag[nm], layout)
                                   for a, nm in zip(jf, ("jx", "jy", "jz")))
        out[("fine" if fine else "coarse") + "_advance_ms"] = cuda_ms(
            lambda: b(e(b(parts), j3)), 3)
    out["coarsen_j_ms"] = cuda_ms(
        lambda: [mr_mod.coarsen_field(a, stag[nm], layout)
                 for a, nm in zip(jf, ("jx", "jy", "jz"))], 3)
    out["patch_ms"] = (out["fine_advance_ms"] + out["coarse_advance_ms"]
                       + out["aux1_ms"] + out["coarsen_j_ms"])
    return out


def mr_finite(sim):
    """Every field of level 0 and every array of the patch finite."""
    f = sim.state.fields
    return (all(bool(torch.isfinite(getattr(f, nm)).all())
                for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy",
                           "jz"))
            and all(bool(torch.isfinite(v).all())
                    for k, v in sim.state.aux.items() if k.startswith("mr:")))


MAIN_MR_STEPS = 6


def main_mr_cfg(subcycled, n=128, steps=MAIN_MR_STEPS):
    """uniform-128-mr: uniform-128's plasma (``main_cfg``: 128^3 cells, 2 x
    2 x 128^3 particles, order 1) with a ratio-2 patch over the central 64^3
    coarse cells (a fine 128^3 plus its 10-cell PML ring), per particle; dt
    at 0.999 of the fine level's Courant limit (the deck reader's rule;
    twice that subcycled)."""
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    cfg = main_cfg(n, steps)
    geom = cfg.geometry
    fine = Geometry(ndim=3, n_cell=tuple(2 * c for c in geom.n_cell),
                    prob_lo=geom.prob_lo, prob_hi=geom.prob_hi,
                    periodic=geom.periodic)
    dt = compute_dt_yee(fine, 0.999) * (2 if subcycled else 1)
    quarter = [0.25 * (hi - lo) for lo, hi in zip(geom.prob_lo,
                                                  geom.prob_hi)]
    return dataclasses.replace(
        cfg, dt=dt, max_level=1, ref_ratio=(2, 2, 2),
        fine_tag_lo=tuple(-q for q in quarter), fine_tag_hi=tuple(quarter),
        do_subcycling=subcycled, tiled_particles="off")


def level_shares(sim):
    """The share of the live particles on level 1 (inside the patch), in
    its gather and in its deposition interior."""
    layout = sim.mr_layout
    counts = [0, 0, 0]
    total = 0
    for sp in sim.state.species.values():
        pos = sp.positions(layout.ndim)
        total += int(sp.alive.sum())
        for i, nbuf in enumerate((0, layout.gather_buf, layout.dep_buf)):
            counts[i] += int((sp.alive & layout.fine_mask(pos, nbuf)).sum())
    return [c / total for c in counts]


def phase_main_mr(dev, smi, steps=MAIN_MR_STEPS):
    """uniform-128-mr (``main_mr_cfg``), float32, per particle (the JAX
    package's MR is per particle; no kernel), plain then subcycled: init, a
    warm step, ``steps`` - 3 timed steps (CUDA events), one step (profiled
    in the plain run), the closing step; the patch's work alone
    (``mr_patch_ms``).  Gates:
    finite fields on both levels, every particle alive, the total weight
    bitwise as injected, the level-1 share of the particles within the
    buffer shell's volume share of the patch's volume share; no kernel
    launched."""
    import warpx_tpu_torch

    runs = {}
    for subcycled in (False, True):
        name = "subcycled" if subcycled else "plain"
        cfg = main_mr_cfg(subcycled, steps=steps)
        before = kernel_counters()
        t0 = time.perf_counter()
        sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32,
                                         device=dev)
        if sim.binned or sim.mr_step is None:
            raise AssertionError("main_mr left the periodic MR step")
        sim.init()
        n = sum(int(sp.alive.sum()) for sp in sim.state.species.values())
        w0 = [float(sp.w.double().sum())
              for sp in sim.state.species.values()]
        sim.evolve(1)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        timed = steps - 3
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(timed + 1)]
        marks[0].record()
        for mark in marks[1:]:
            sim.evolve(1)
            mark.record()
        marks[-1].synchronize()
        series = [round(a.elapsed_time(b), 3)
                  for a, b in zip(marks, marks[1:])]
        t1 = time.perf_counter()
        # one profile: reading a step's trace back takes seconds
        breakdown = (profile_steps(sim, 1) if not subcycled else
                     {"device_busy_share": "not measured",
                      "device_ms_per_step": "not measured", "top": []})
        if subcycled:
            sim.evolve(1)
        t2 = time.perf_counter()
        patch = mr_patch_ms(sim)
        sim.evolve()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launched = [a - b for a, b in zip(kernel_counters(), before)]
        layout = sim.mr_layout
        shares = level_shares(sim)
        vol = float(np.prod(layout.nc) / np.prod(layout.n0))
        # the buffer shell: the patch less its gather interior
        margin = vol * (1.0 - float(np.prod(
            [(f - 2 * layout.gather_buf) / f for f in layout.nf])))
        alive = sum(int(sp.alive.sum())
                    for sp in sim.state.species.values())
        w1 = [float(sp.w.double().sum())
              for sp in sim.state.species.values()]
        finite = mr_finite(sim)
        ms_step = sum(series) / timed
        runs[name] = {
            "dt": cfg.dt, "steps": sim.state.step, "steps_timed": timed,
            "ms_per_step": ms_step, "pushes_per_s": n / (ms_step * 1e-3),
            "ms_each_step": series, "init_s": init_s,
            "device_busy_share": breakdown["device_busy_share"],
            "device_ms_per_step": breakdown["device_ms_per_step"],
            "patch": patch, "level1_share": shares[0],
            "gather_interior_share": shares[1],
            "deposit_interior_share": shares[2], "patch_volume_share": vol,
            "share_margin": margin, "n_particles": n, "alive": alive,
            "weight_bitwise": w1 == w0, "finite": finite,
            "kernel_launches": launched, "profile_top": breakdown["top"][:8],
            "wall_s": {"to_profile": t1 - t0, "profile": t2 - t1,
                       "patch_and_last": t3 - t2,
                       "gates": time.perf_counter() - t3}}
        if not (finite and alive == n and w1 == w0 and not any(launched)
                and abs(shares[0] - vol) <= margin):
            raise AssertionError(f"main_mr {name}: {runs[name]}")
        del sim
        torch.cuda.empty_cache()
    emit("main_mr", ok=True, n_cell=(128,) * 3, patch_coarse_cells=(64,) * 3,
         ref_ratio=2, order=1, dtype="float32", **runs,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)


MAIN_LWFA_MR_STEPS = 5


def main_lwfa_mr_cfg(nx=2048, nz=8192, steps=MAIN_LWFA_MR_STEPS):
    """lwfa2d-2048x8192-mr: main_lwfa's deck (``main_lwfa_cfg``: 2048 x
    8192, 2 x 2 electrons a cell, PML, the window, the filter, order 3)
    with a ratio-2 patch of 512 x 1024 coarse cells, centered across and
    from 2.44 um to 10.94 um along z at the start (the antenna at 9 um and
    the plasma behind it), riding the window, refine_plasma on; per
    particle; dt at 0.98 of the fine level's Courant limit."""
    from warpx_tpu_torch.core.grid import Geometry
    from warpx_tpu_torch.solvers.yee import compute_dt_yee

    cfg = main_lwfa_cfg(nx, nz, steps)
    geom = cfg.geometry
    fine = Geometry(ndim=2, n_cell=tuple(2 * c for c in geom.n_cell),
                    prob_lo=geom.prob_lo, prob_hi=geom.prob_hi,
                    periodic=geom.periodic)
    dx, dz = geom.dx
    ix = (nx // 2 - nx // 8, nx // 2 + nx // 8)
    iz = (nz - 9 * nz // 64, nz - nz // 64)
    return dataclasses.replace(
        cfg, dt=compute_dt_yee(fine, 0.98), max_level=1, ref_ratio=(2, 2),
        fine_tag_lo=(geom.prob_lo[0] + ix[0] * dx,
                     geom.prob_lo[1] + iz[0] * dz),
        fine_tag_hi=(geom.prob_lo[0] + ix[1] * dx,
                     geom.prob_lo[1] + iz[1] * dz),
        refine_plasma=True, tiled_particles="off")


def refined_row_count(cfg, layout):
    """Electrons a cell row across x of the refined lattice, counted on the
    host in float64 from the deck's numbers: 2 x 2 a coarse cell in bounds
    outside the patch's x footprint, 4 x 4 (the fine lattice's 2 x 2 a
    fine cell) inside it."""
    sp = cfg.species[0]
    geom = cfg.geometry
    dx = geom.dx[0]
    ppx, ppz = sp.num_particles_per_cell_each_dim[:2]
    r = layout.rv[0]
    i = np.arange(geom.n_cell[0])[:, None]
    u = (np.arange(ppx) + 0.5) / ppx
    inside = (i >= layout.i0[0]) & (i < layout.i1[0])
    xc = geom.prob_lo[0] + (i + u[None, :]) * dx
    sub = (np.arange(r)[:, None] + u[None, :]).reshape(-1) / r
    xf = geom.prob_lo[0] + (i + sub[None, :]) * dx

    def inb(x):
        return (x >= sp.bounds_lo[0]) & (x <= sp.bounds_hi[0])
    coarse = int((inb(xc) & ~inside).sum()) * ppz
    refined = int((inb(xf) & inside).sum()) * ppz * layout.rv[1]
    return coarse + refined


def phase_main_lwfa_mr(dev, smi, steps=MAIN_LWFA_MR_STEPS):
    """lwfa2d-2048x8192-mr (``main_lwfa_mr_cfg``), float32, per particle
    (the JAX package's bounded MR is per particle; no kernel): init, a warm
    step, ``steps`` - 3 timed steps, one profiled step, the closing step;
    the patch's work alone.  Gates: finite fields on both levels; the
    electrons alive exactly a refined row's count (``refined_row_count``)
    times the cells between the window's lower edge and the injection
    front, at init and at the end (the plasma at rest, the refined
    injection at init and on the window's move); no kernel launched."""
    import warpx_tpu_torch

    cfg = main_lwfa_mr_cfg(steps=steps)
    before = kernel_counters()
    t0 = time.perf_counter()
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    sim.init()
    if sim.binned or not sim.is_bounded or sim.stepper.mr is None:
        raise AssertionError("main_lwfa_mr left the bounded MR step")
    torch.cuda.synchronize()
    host_init_s = time.perf_counter() - t0
    layout = sim.mr_layout
    row = refined_row_count(cfg, layout)
    dz = cfg.geometry.dx[1]

    def expected():
        lo = float(sim.state.aux["window_lo"])
        front = float(sim.state.aux["inject_pos:electrons"])
        return row * int(round((front - lo) / dz))

    def alive():
        return int(sim.state.species["electrons"].alive.sum())

    n0, e0 = alive(), expected()
    sim.evolve(1)
    timed = steps - 3
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
    marks[0].record()
    for mark in marks[1:]:
        sim.evolve(1)
        mark.record()
    marks[-1].synchronize()
    series = [round(a.elapsed_time(b), 3) for a, b in zip(marks, marks[1:])]
    breakdown = profile_steps(sim, 1)
    patch = mr_patch_ms(sim)
    sim.evolve()
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(kernel_counters(), before)]
    n1, e1 = alive(), expected()
    finite = mr_finite(sim)
    ms_step = sum(series) / timed
    out = dict(n_cell=cfg.geometry.n_cell, patch_coarse_cells=layout.nc,
               patch_i0=layout.i0, ref_ratio=2, order=3, dtype="float32",
               dt=cfg.dt, steps=sim.state.step, steps_timed=timed,
               ms_per_step=ms_step, pushes_per_s=n1 / (ms_step * 1e-3),
               ms_each_step=series, host_init_s=host_init_s,
               device_busy_share=breakdown["device_busy_share"],
               device_ms_per_step=breakdown["device_ms_per_step"],
               patch=patch, row_count=row, alive_init=n0,
               expected_init=e0, alive_end=n1, expected_end=e1,
               window_offset=int(sim.state.aux["window_offset"]),
               finite=finite, kernel_launches=launched,
               profile_top=breakdown["top"][:8],
               device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    if not (finite and n0 == e0 and n1 == e1 and not any(launched)
            and out["window_offset"] > 0):
        raise AssertionError(f"main_lwfa_mr: {out}")
    emit("main_lwfa_mr", ok=True, **out)
    del sim
    torch.cuda.empty_cache()


# ---- RZ geometry: the cylindrical FDTD step and the Hankel PSATD step -----

# The RZ deck texts: the templates of tests/test_torch_rz_util.py, copied
# (this script imports no test module; tests/test_torch_rz_bounded.py holds
# the copies equal), which rz_parity runs; and the two cells' decks.
RZ_TEST_DECKS = {
    "langmuir": """
max_step = {steps}
amr.n_cell = 16 32
geometry.dims = RZ
geometry.prob_lo = 0. -20.e-6
geometry.prob_hi = 20.e-6 20.e-6
boundary.field_lo = none periodic
boundary.field_hi = pec periodic
warpx.n_rz_azimuthal_modes = {modes}
warpx.cfl = 0.9
algo.particle_shape = {order}
my_constants.epsilon = 0.01
my_constants.n0 = 2.e24
my_constants.w0 = 5.e-6
my_constants.k0 = 2*pi*2/40.e-6
particles.species_names = electrons
electrons.charge = -q_e
electrons.mass = m_e
electrons.injection_style = "NUniformPerCell"
electrons.num_particles_per_cell_each_dim = 2 4 1
electrons.profile = constant
electrons.density = n0
electrons.momentum_distribution_type = parse_momentum_function
electrons.momentum_function_ux(x,y,z) = "epsilon*(2*x/w0**2 + 1/w0)*w0*exp(-(x**2+y**2)/w0**2)*sin(k0*z)"
electrons.momentum_function_uy(x,y,z) = "epsilon*2*y/w0*exp(-(x**2+y**2)/w0**2)*sin(k0*z)"
electrons.momentum_function_uz(x,y,z) = "-epsilon*exp(-(x**2+y**2)/w0**2)*cos(k0*z)"
{extra}
""",
    "lwfa": """
max_step = {steps}
amr.n_cell = {nr} {nz}
geometry.dims = RZ
geometry.prob_lo = 0. -56.e-6
geometry.prob_hi = 30.e-6 12.e-6
boundary.field_lo = none pec
boundary.field_hi = pec pec
warpx.n_rz_azimuthal_modes = {modes}
warpx.cfl = 1.
warpx.do_moving_window = 1
warpx.moving_window_dir = z
warpx.moving_window_v = 1.0
algo.particle_shape = {order}
particles.species_names = electrons beam
electrons.charge = -q_e
electrons.mass = m_e
electrons.injection_style = "NUniformPerCell"
electrons.num_particles_per_cell_each_dim = 1 4 1
electrons.xmax = 25.e-6
electrons.zmin = 5.e-6
electrons.profile = constant
electrons.density = 2.e23
electrons.do_continuous_injection = 1
{plasma_extra}
beam.charge = -q_e
beam.mass = m_e
beam.injection_style = "gaussian_beam"
beam.x_rms = 1.e-6
beam.y_rms = 1.e-6
beam.z_rms = 1.e-6
beam.x_m = 0.
beam.y_m = 0.
beam.z_m = -40.e-6
beam.npart = 128
beam.q_tot = -1.e-12
beam.momentum_distribution_type = "gaussian"
beam.ux_m = 0.0
beam.uy_m = 0.0
beam.uz_m = 200.
beam.ux_th = .2
beam.uy_th = .2
beam.uz_th = 2.
lasers.names = laser1
laser1.profile = Gaussian
laser1.position = 0. 0. 9.e-6
laser1.direction = 0. 0. 1.
laser1.polarization = 1. 0. 0.
laser1.a0 = 2.
laser1.wavelength = 0.8e-6
laser1.profile_waist = 5.e-6
laser1.profile_duration = 15.e-15
laser1.profile_t_peak = 30.e-15
laser1.profile_focal_distance = 100.e-6
{extra}
""",
    "silver_mueller": """
max_step = {steps}
amr.n_cell = 16 64
geometry.dims = RZ
geometry.prob_lo = 0. -10.e-6
geometry.prob_hi = 8.e-6 10.e-6
boundary.field_lo = none absorbing_silver_mueller
boundary.field_hi = absorbing_silver_mueller absorbing_silver_mueller
warpx.n_rz_azimuthal_modes = 2
warpx.cfl = 0.9
algo.particle_shape = 1
lasers.names = laser1
laser1.profile = Gaussian
laser1.position = 0. 0. -6.e-6
laser1.direction = 0. 0. 1.
laser1.polarization = 1. 0. 0.
laser1.e_max = 1.e12
laser1.wavelength = 1.e-6
laser1.profile_waist = 3.e-6
laser1.profile_duration = 4.e-15
laser1.profile_t_peak = 8.e-15
laser1.profile_focal_distance = 0.
{extra}
""",
    "eb": """
max_step = {steps}
amr.n_cell = 16 64
geometry.dims = RZ
geometry.prob_lo = 0. -8.e-6
geometry.prob_hi = 8.e-6 8.e-6
boundary.field_lo = none pec
boundary.field_hi = pec pec
warpx.n_rz_azimuthal_modes = 2
warpx.cfl = 0.9
warpx.eb_implicit_function = "-max(x - 3.e-6, abs(z) - 0.1e-6)"
lasers.names = laser1
laser1.profile = Gaussian
laser1.position = 0. 0. -6.e-6
laser1.direction = 0. 0. 1.
laser1.polarization = 1. 0. 0.
laser1.e_max = 1.e12
laser1.wavelength = 1.e-6
laser1.profile_waist = 4.e-6
laser1.profile_duration = 4.e-15
laser1.profile_t_peak = 8.e-15
laser1.profile_focal_distance = 0.
{extra}
""",
    "psatd": """
max_step = {steps}
amr.n_cell = 16 32
geometry.dims = RZ
geometry.prob_lo = 0. -16.e-6
geometry.prob_hi = 16.e-6 16.e-6
boundary.field_lo = none periodic
boundary.field_hi = pec periodic
warpx.n_rz_azimuthal_modes = 2
warpx.cfl = 0.9
algo.maxwell_solver = psatd
algo.current_deposition = direct
algo.particle_shape = {order}
psatd.noz = 8
my_constants.n0 = 1.e24
my_constants.w0 = 5.e-6
particles.species_names = electrons ions
electrons.charge = -q_e
electrons.mass = m_e
electrons.injection_style = "NUniformPerCell"
electrons.num_particles_per_cell_each_dim = 1 4 1
electrons.profile = parse_density_function
electrons.density_function(x,y,z) = "n0*exp(-(x**2+y**2)/(4*w0**2))*(1 + 0.05*x/w0)"
electrons.momentum_distribution_type = parse_momentum_function
electrons.momentum_function_ux(x,y,z) = "0.01*exp(-(x**2+y**2)/w0**2)"
electrons.momentum_function_uy(x,y,z) = "0."
electrons.momentum_function_uz(x,y,z) = "{uz}"
ions.charge = q_e
ions.mass = m_p
ions.injection_style = "NUniformPerCell"
ions.num_particles_per_cell_each_dim = 1 4 1
ions.profile = parse_density_function
ions.density_function(x,y,z) = "n0*exp(-(x**2+y**2)/(4*w0**2))"
ions.momentum_distribution_type = constant
ions.uz = {uz}
{extra}
""",
}

RZ_LWFA_DECK = """
max_step = {steps}
amr.n_cell = {nr} {nz}
geometry.dims = RZ
geometry.prob_lo = 0. -56.e-6
geometry.prob_hi = 30.e-6 12.e-6
boundary.field_lo = none pec
boundary.field_hi = pec pec
warpx.n_rz_azimuthal_modes = 2
warpx.cfl = {cfl}
warpx.do_moving_window = 1
warpx.moving_window_dir = z
warpx.moving_window_v = 1.0
algo.particle_shape = 3
particles.species_names = electrons beam
electrons.charge = -q_e
electrons.mass = m_e
electrons.injection_style = "NUniformPerCell"
electrons.num_particles_per_cell_each_dim = 1 4 1
electrons.xmax = {rmax_plasma}
electrons.zmin = -56.e-6
electrons.profile = constant
electrons.density = 2.e23
electrons.do_continuous_injection = 1
electrons.random_theta = 1
{plasma_extra}
beam.charge = -q_e
beam.mass = m_e
beam.injection_style = "gaussian_beam"
beam.x_rms = 0.5e-6
beam.y_rms = 0.5e-6
beam.z_rms = 0.5e-6
beam.z_m = -28.e-6
beam.npart = 100
beam.q_tot = -1.e-12
beam.momentum_distribution_type = "gaussian"
beam.uz_m = 500.
beam.ux_th = 2.
beam.uy_th = 2.
beam.uz_th = 50.
lasers.names = laser1
laser1.profile = Gaussian
laser1.position = 0. 0. 9.e-6
laser1.direction = 0. 0. 1.
laser1.polarization = 1. 0. 0.
laser1.e_max = 16.e12
laser1.wavelength = 0.8e-6
laser1.profile_waist = 5.e-6
laser1.profile_duration = 15.e-15
laser1.profile_t_peak = 30.e-15
laser1.profile_focal_distance = 100.e-6
"""

RZ_PSATD_DECK = """
max_step = {steps}
amr.n_cell = {nr} {nz}
geometry.dims = RZ
geometry.prob_lo = 0. {zlo}
geometry.prob_hi = {rmax} {zhi}
boundary.field_lo = none periodic
boundary.field_hi = pec periodic
warpx.n_rz_azimuthal_modes = 2
warpx.cfl = 0.9
algo.maxwell_solver = psatd
algo.current_deposition = direct
algo.particle_shape = {order}
psatd.noz = {noz}
particles.species_names = electrons ions
electrons.charge = -q_e
electrons.mass = m_e
electrons.injection_style = "NUniformPerCell"
electrons.num_particles_per_cell_each_dim = 1 4 1
electrons.xmax = {rmax_plasma}
electrons.profile = constant
electrons.density = {density}
electrons.momentum_distribution_type = parse_momentum_function
electrons.momentum_function_ux(x,y,z) = "{ux}"
electrons.momentum_function_uy(x,y,z) = "0."
electrons.momentum_function_uz(x,y,z) = "{uz}"
ions.charge = q_e
ions.mass = m_p
ions.injection_style = "NUniformPerCell"
ions.num_particles_per_cell_each_dim = 1 4 1
ions.xmax = {rmax_plasma}
ions.profile = constant
ions.density = {density}
ions.momentum_distribution_type = constant
ions.uz = {uz}
{extra}
"""


def rz_parity_cases():
    """(name, deck text) of rz_parity: the tests' decks, the LWFA at
    32 x 256 and order 3."""
    t = RZ_TEST_DECKS
    warm = ("electrons.momentum_distribution_type = gaussian\n"
            "electrons.ux_th = 0.01\nelectrons.uy_th = 0.01\n"
            "electrons.uz_th = 0.01\nelectrons.random_theta = 1")
    return [
        ("langmuir_m2", t["langmuir"].format(steps=6, modes=2, order=2,
                                             extra="")),
        ("lwfa_32x256", t["lwfa"].format(steps=10, modes=2, nr=32, nz=256,
                                         order=3, plasma_extra=warm,
                                         extra="")),
        ("silver_mueller", t["silver_mueller"].format(steps=20, extra="")),
        ("eb", t["eb"].format(steps=20, extra="")),
        ("psatd", t["psatd"].format(
            steps=6, order=1, uz="0.", extra="psatd.current_correction = 0\n"
                                             "psatd.update_with_rho = 0")),
        ("psatd_cc", t["psatd"].format(steps=6, order=1, uz="0.", extra="")),
        ("psatd_galilean", t["psatd"].format(
            steps=6, order=1, uz="10.",
            extra="psatd.v_galilean = 0. 0. 0.99498743710662")),
    ]


def rz_checksums_agree(got, ref, tol, what):
    """The RZ checksums, each within ``tol`` of its group's largest: the
    E, B, J, rho and div E sums of every mode a group each (a mode the run
    does not drive sits at roundoff), a species' sums each on its own."""
    worst = 0.0
    for group in ref:
        if set(got[group]) != set(ref[group]):
            raise AssertionError(f"{what}: {group} holds "
                                 f"{sorted(got[group])}")
        scale = {}

        def key(q):
            return q[0] if group == "lev=0" else q
        for q, a in ref[group].items():
            scale[key(q)] = max(scale.get(key(q), 0.0), abs(a))
        for q, a in ref[group].items():
            s = scale[key(q)]
            r = abs(got[group][q] - a) / s if s else abs(got[group][q])
            worst = max(worst, r)
            if not r <= tol:
                raise AssertionError(f"{what} checksum {group}/{q}: "
                                     f"{got[group][q]!r} vs {a!r}")
    return worst


def rz_extra_fields_agree(got, ref, tol, what):
    """F and the Silver-Mueller rings, where a run has them."""
    worst = 0.0
    pairs = []
    if ref.state.fields.F is not None:
        pairs.append(("F", got.state.fields.F, ref.state.fields.F))
    for k, v in (ref.state.fields.smg or {}).items():
        pairs.append((f"smg:{k}", got.state.fields.smg[k], v))
    for name, a, b in pairs:
        _, rel = rel_err(a.cpu(), b)
        worst = max(worst, rel)
        if not rel <= tol:
            raise AssertionError(f"{what}: {name} differs by {rel}")
    return worst


def phase_rz_parity(dev):
    """rz_parity: RZ in float64, card against CPU on the same numbers (the
    decks of tests/test_torch_rz*.py, which hold the port to the JAX
    package): the RZ Langmuir wave at 2 modes on periodic z; the RZ LWFA at
    32 x 256 (PEC z walls, the window, the antenna, continuous injection
    with random_theta and warm momenta, a Gaussian beam); Silver-Mueller
    faces; a laser around an embedded disk; PSATD standard, with current
    correction, Galilean.  Fields (F and the rings too), species (theta
    too) within 1e-9 of their largest values, the RZ checksums within 1e-9
    of their groups'; RZ runs per particle, so no kernel is launched."""
    out = {}
    for name, text in rz_parity_cases():
        before = kernel_counters()
        t0 = time.perf_counter()
        card = stochastic_run(text, dev, torch.float64)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launched = [a - b for a, b in zip(kernel_counters(), before)]
        cpu = stochastic_run(text, "cpu", torch.float64)
        if card.rz is None or card.binned or any(launched):
            raise AssertionError(f"rz_parity {name}: rz {card.rz}, binned "
                                 f"{card.binned}, kernels {launched}")
        worst = states_agree(card, cpu, 1e-9, f"rz_parity {name}")
        worst_extra = rz_extra_fields_agree(card, cpu, 1e-9,
                                            f"rz_parity {name}")
        worst_sum = rz_checksums_agree(card.checksums(), cpu.checksums(),
                                       1e-9, f"rz_parity {name}")
        out[name] = {"max_rel_err": worst,
                     "f_and_rings_max_rel_err": worst_extra,
                     "checksum_max_rel_err": worst_sum,
                     "solver": card.cfg.em_solver,
                     "modes": card.cfg.n_rz_modes,
                     "window_lo": float(card.state.aux.get("window_lo",
                                                           0.0)),
                     "alive": {nm: int(sp.alive.sum())
                               for nm, sp in card.state.species.items()},
                     "card_s": card_s}
    emit("rz_parity", ok=True, tol=1e-9, kernel_launches=0, cases=out)


MAIN_RZ_LWFA_STEPS = 6


def rz_lwfa_deck(nr=1024, nz=8192, steps=MAIN_RZ_LWFA_STEPS):
    """rz-lwfa-1024x8192: the reference's RZ laser-wakefield deck in form
    (inputs_test_rz_laser_acceleration) at this repo's LWFA resolution: r
    in [0, 30 um] over ``nr`` cells and z in [-56, 12] um over ``nz`` (the
    2D deck's cell sizes), 2 azimuthal modes, PEC z walls, the window at c,
    main_lwfa's Gaussian antenna (x-polarized), electrons at 1 x 4 x 1 a
    cell over the whole radius with random_theta, continuously injected,
    a 100-particle Gaussian beam, order 3, the filter on, dt at the RZ
    Courant limit."""
    return RZ_LWFA_DECK.format(steps=steps, nr=nr, nz=nz, cfl=0.999,
                               rmax_plasma="30.e-6", plasma_extra="")


def rz_finite(sim):
    f = sim.state.fields
    return all(bool(torch.isfinite(getattr(f, nm)).all())
               for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy",
                          "jz"))


def phase_main_rz_lwfa(dev, smi, nr=1024, nz=8192,
                       steps=MAIN_RZ_LWFA_STEPS):
    """rz-lwfa-1024x8192 (``rz_lwfa_deck``) through Simulation.from_deck,
    float32, per particle (the JAX package's RZ step is per particle; no
    kernel): init, a warm step, ``steps`` - 3 timed steps (CUDA events),
    one profiled step, the closing step.  Gates: finite fields; the
    electrons alive exactly 4 nr a cell row times the rows between the
    window's edge at the last step's start and the injection front (the
    plasma at rest there, injected by whole columns); the antenna's m = 1
    field nonzero after the window moved; no kernel launched."""
    import warpx_tpu_torch
    from warpx_tpu_torch.utils.parser import Deck

    text = rz_lwfa_deck(nr, nz, steps)
    before = kernel_counters()
    t0 = time.perf_counter()
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float32, device=dev)
    sim.init()
    torch.cuda.synchronize()
    host_init_s = time.perf_counter() - t0
    if sim.rz is None or sim.binned:
        raise AssertionError("main_rz_lwfa left the RZ FDTD step")
    cfg = sim.cfg
    dz = cfg.geometry.dx[1]
    row = 4 * nr

    def alive():
        return int(sim.state.species["electrons"].alive.sum())

    def expected(lo):
        front = float(sim.state.aux["inject_pos:electrons"])
        return row * int(round((front - lo) / dz))

    n0, e0 = alive(), expected(float(sim.state.aux["window_lo"]))
    sim.evolve(1)
    timed = steps - 3
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
    marks[0].record()
    for mark in marks[1:]:
        sim.evolve(1)
        mark.record()
    marks[-1].synchronize()
    series = [round(a.elapsed_time(b), 3) for a, b in zip(marks, marks[1:])]
    breakdown = profile_steps(sim, 1)
    lo_last = float(sim.state.aux["window_lo"])
    sim.evolve()
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(kernel_counters(), before)]
    n1, e1 = alive(), expected(lo_last)
    ey = sim.state.fields.Ey
    m1 = float(ey[1:].abs().max())
    finite = rz_finite(sim)
    moved = float(sim.state.aux["window_lo"]) > cfg.geometry.prob_lo[1]
    ms_step = sum(series) / timed
    n_all = sum(int(sp.alive.sum()) for sp in sim.state.species.values())
    out = dict(n_cell=cfg.geometry.n_cell, modes=cfg.n_rz_modes, order=3,
               dtype="float32", dt=cfg.dt, steps=sim.state.step,
               steps_timed=timed, ms_per_step=ms_step,
               pushes_per_s=n_all / (ms_step * 1e-3), ms_each_step=series,
               host_init_s=host_init_s,
               device_busy_share=breakdown["device_busy_share"],
               device_ms_per_step=breakdown["device_ms_per_step"],
               electrons_init=n0, expected_init=e0, electrons_end=n1,
               expected_end=e1,
               beam_alive=int(sim.state.species["beam"].alive.sum()),
               window_moved_m=float(sim.state.aux["window_lo"])
               - cfg.geometry.prob_lo[1],
               et_mode1_max=m1, et_mode0_max=float(ey[0].abs().max()),
               finite=finite, kernel_launches=launched,
               profile_top=breakdown["top"][:8],
               device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    if not (finite and n0 == e0 and n1 == e1 and moved and m1 > 0.0
            and not any(launched)):
        raise AssertionError(f"main_rz_lwfa: {out}")
    emit("main_rz_lwfa", ok=True, **out)
    del sim
    torch.cuda.empty_cache()


MAIN_RZ_PSATD_STEPS = 6
# u_z = 10 (gamma beta): beta = 10 / sqrt(101)
RZ_GALILEAN_BETA = 10.0 / math.sqrt(101.0)


def rz_psatd_deck(nr=512, nz=4096, steps=MAIN_RZ_PSATD_STEPS):
    """rz-psatd-galilean-512x4096: BASELINE.json configuration 3's spectral
    solve at production width on the reference's Galilean RZ stability
    setup (nci_psatd_stability/inputs_test_rz_galilean_psatd in form):
    periodic z, ``nr`` x ``nz`` cells of 0.3125 um (uniform-128-galilean's
    cell), 2 modes, psatd.noz = 16, update-with-rho and current correction
    (the RZ reader's defaults), electrons and protons at 2e24 m^-3, 1 x 4 x
    1 a cell each within 0.95 of the radius, drifting at u_z = 10 with
    v_galilean at that drift; the direct cell-centered deposit, order 3."""
    cell = 0.3125e-6
    return RZ_PSATD_DECK.format(
        steps=steps, nr=nr, nz=nz, zlo=repr(-nz * cell / 2),
        zhi=repr(nz * cell / 2), rmax=repr(nr * cell), order=3, noz=16,
        rmax_plasma=repr(0.95 * nr * cell), density="2.e24", ux="0.",
        uz="10.", extra=f"psatd.v_galilean = 0. 0. {RZ_GALILEAN_BETA!r}")


def rz_energies(sim):
    """(field energy, kinetic energy) in J: the modes' E and B over the
    rings (2 pi r dr dz; mode 0 once, each cos/sin pair half), cell
    centered; sum w m c^2 (gamma - 1) over the live particles."""
    from warpx_tpu_torch.rz.core import _rz_center

    cfg = sim.cfg
    geom = cfg.geometry
    dr, dz = geom.dx
    r = (torch.arange(geom.n_cell[0], dtype=torch.float64,
                      device=sim.device) + 0.5) * dr
    vol = (2.0 * math.pi * r * dr * dz)[:, None]
    f = sim.state.fields
    ep0, mu0, c = 8.8541878128e-12, 1.25663706212e-06, 299792458.0
    wf = 0.0
    for nm, attr, k in (("Er", "Ex", ep0), ("Et", "Ey", ep0),
                        ("Ez", "Ez", ep0), ("Br", "Bx", 1 / mu0),
                        ("Bt", "By", 1 / mu0), ("Bz", "Bz", 1 / mu0)):
        arr = getattr(f, attr).double()
        for ci in range(arr.shape[0]):
            a = _rz_center(arr[ci], nm, cfg)
            wf += 0.5 * k * (1.0 if ci == 0 else 0.5) * float(
                (a * a * vol).sum())
    wk = 0.0
    for sp_cfg in cfg.species:
        sp = sim.state.species[sp_cfg.name]
        u2 = (sp.ux.double() ** 2 + sp.uy.double() ** 2
              + sp.uz.double() ** 2) / (c * c)
        gm1 = u2 / (torch.sqrt(1.0 + u2) + 1.0)
        wk += float((torch.where(sp.alive, sp.w.double(), 0.0) * gm1).sum()
                    ) * sp_cfg.mass * c * c
    return wf, wk


def phase_main_rz_psatd(dev, smi, nr=512, nz=4096,
                        steps=MAIN_RZ_PSATD_STEPS):
    """rz-psatd-galilean-512x4096 (``rz_psatd_deck``) through
    Simulation.from_deck, float32, per particle (no kernel): init, a warm
    step, ``steps`` - 3 timed steps, one profiled step, the closing step;
    then, on the end state, the spectral push alone, each Hankel + FFT
    transform alone, the electrons' current and rho deposits alone (CUDA
    events); the field energy against the plasma's kinetic energy.  Gates:
    finite fields, no particle lost, no kernel launched."""
    import warpx_tpu_torch
    from warpx_tpu_torch.rz.spectral import deposit_cc_rz
    from warpx_tpu_torch.utils.parser import Deck

    text = rz_psatd_deck(nr, nz, steps)
    before = kernel_counters()
    t0 = time.perf_counter()
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float32, device=dev)
    sim.init()
    torch.cuda.synchronize()
    host_init_s = time.perf_counter() - t0
    if sim.rz is None or sim.cfg.em_solver != "psatd":
        raise AssertionError("main_rz_psatd left the RZ spectral step")
    cfg = sim.cfg
    n0 = sum(int(sp.alive.sum()) for sp in sim.state.species.values())
    sim.evolve(1)
    timed = steps - 3
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
    marks[0].record()
    for mark in marks[1:]:
        sim.evolve(1)
        mark.record()
    marks[-1].synchronize()
    series = [round(a.elapsed_time(b), 3) for a, b in zip(marks, marks[1:])]
    breakdown = profile_steps(sim, 1)
    sim.evolve()
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(kernel_counters(), before)]
    n1 = sum(int(sp.alive.sum()) for sp in sim.state.species.values())
    finite = rz_finite(sim)
    # the pieces alone on the end state
    solver = sim.rz.solver
    f = sim.state.fields
    rho = torch.zeros_like(f.Ex)
    sp = sim.state.species["electrons"]
    sp_cfg = cfg.species[0]
    pos = (sp.x, sp.y, sp.z)
    order = cfg.particle_shape
    alone = {
        "push_with_rho_pair": cuda_ms(lambda: solver.push(f, (rho, rho)), 3),
        "fwd_vector": cuda_ms(lambda: solver.fwd_vector(f.Ex, f.Ey), 5),
        "fwd_scalar": cuda_ms(lambda: solver.fwd_scalar(f.Ez), 5),
        "deposit_j_electrons": cuda_ms(lambda: deposit_cc_rz(
            pos, sp.w, sp_cfg.charge, cfg, order, order + 2, torch.float32,
            vel=(sp.ux, sp.uy, sp.uz), dt=cfg.dt), 2),
        "deposit_rho_electrons": cuda_ms(lambda: deposit_cc_rz(
            pos, sp.w, sp_cfg.charge, cfg, order, order + 2,
            torch.float32), 2),
    }
    U = solver.fwd_scalar(f.Ez)
    alone["bwd_vector"] = cuda_ms(
        lambda: solver.bwd_vector(U, U, torch.float32), 5)
    alone["bwd_scalar"] = cuda_ms(
        lambda: solver.bwd_scalar(U, torch.float32), 5)
    # a push: 3 vector and 5 scalar forward transforms, 3 and 3 backward
    # (the corrected current's included)
    alone["transforms_in_a_push"] = (
        3 * (alone["fwd_vector"] + alone["bwd_vector"])
        + 5 * alone["fwd_scalar"] + 3 * alone["bwd_scalar"])
    wf, wk = rz_energies(sim)
    ms_step = sum(series) / timed
    out = dict(n_cell=cfg.geometry.n_cell, modes=cfg.n_rz_modes,
               order=order, psatd_noz=cfg.psatd_order,
               v_galilean_over_c=RZ_GALILEAN_BETA, dtype="float32",
               dt=cfg.dt, steps=sim.state.step, steps_timed=timed,
               ms_per_step=ms_step, pushes_per_s=n1 / (ms_step * 1e-3),
               ms_each_step=series, host_init_s=host_init_s,
               device_busy_share=breakdown["device_busy_share"],
               device_ms_per_step=breakdown["device_ms_per_step"],
               alone_ms=alone, field_energy_J=wf, kinetic_energy_J=wk,
               field_over_kinetic=wf / wk if wk else None,
               n_particles=n0, alive_end=n1, finite=finite,
               kernel_launches=launched, profile_top=breakdown["top"][:8],
               device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    if not (finite and n1 == n0 and not any(launched)):
        raise AssertionError(f"main_rz_psatd: {out}")
    emit("main_rz_psatd", ok=True, **out)
    del sim, f, U, rho, sp, pos
    torch.cuda.empty_cache()


# ---- ROADMAP Queue A 14: multiple GPUs (one rank on this card) -------------

# tests/test_torch_sharded.py's 2D Langmuir deck (its current has a curl)
DIST_LANGMUIR_2D = """
max_step = 5
amr.n_cell = 32 32
geometry.dims = 2
geometry.prob_lo = -20.e-6 -20.e-6
geometry.prob_hi =  20.e-6  20.e-6
algo.current_deposition = esirkepov
algo.particle_shape = 1
warpx.cfl = 1.0
warpx.use_filter = 0
my_constants.epsilon = 0.01
my_constants.k = 157079.63267948965
my_constants.kp = 376357.71
particles.species_names = electrons positrons
electrons.charge = -q_e
electrons.mass = m_e
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 2 2
electrons.profile = constant
electrons.density = 2.e24
electrons.momentum_distribution_type = parse_momentum_function
electrons.momentum_function_ux(x,y,z) = "epsilon * k/kp * sin(k*x) * cos(k*z)"
electrons.momentum_function_uy(x,y,z) = "0."
electrons.momentum_function_uz(x,y,z) = "0."
positrons.charge = q_e
positrons.mass = m_e
positrons.injection_style = NUniformPerCell
positrons.num_particles_per_cell_each_dim = 2 2
positrons.profile = constant
positrons.density = 2.e24
positrons.momentum_distribution_type = parse_momentum_function
positrons.momentum_function_ux(x,y,z) = "-epsilon * k/kp * sin(k*x) * cos(k*z)"
positrons.momentum_function_uy(x,y,z) = "0."
positrons.momentum_function_uz(x,y,z) = "0."
"""

# tests/test_torch_sharded.py's 3D thermal deck
DIST_THERMAL_3D = """
max_step = 3
amr.n_cell = 16 16 16
geometry.dims = 3
geometry.prob_lo = -8.e-6 -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6  8.e-6
algo.current_deposition = esirkepov
algo.particle_shape = 1
warpx.cfl = 0.9
warpx.use_filter = 0
particles.species_names = electrons protons
electrons.charge = -q_e
electrons.mass = m_e
electrons.injection_style = nuniformpercell
electrons.num_particles_per_cell_each_dim = 1 1 2
electrons.profile = constant
electrons.density = 1.e24
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.05
electrons.uy_th = 0.05
electrons.uz_th = 0.05
protons.charge = q_e
protons.mass = m_p
protons.injection_style = nuniformpercell
protons.num_particles_per_cell_each_dim = 1 1 1
protons.profile = constant
protons.density = 1.e24
protons.momentum_distribution_type = at_rest
"""

# tests/test_load_balance.py's _CORNER_3D: all plasma in the lowest-z corner
DIST_CORNER_3D = """
max_step = 6
amr.n_cell = 16 16 64
geometry.dims = 3
geometry.prob_lo = -8e-6 -8e-6 -8e-6
geometry.prob_hi = 8e-6 8e-6 8e-6
algo.current_deposition = esirkepov
algo.particle_shape = 2
warpx.cfl = 0.9
warpx.use_filter = 0
particles.species_names = electrons
electrons.charge = -q_e
electrons.mass = m_e
electrons.injection_style = nuniformpercell
electrons.num_particles_per_cell_each_dim = 2 1 1
electrons.profile = parse_density_function
electrons.density_function(x,y,z) = "if(z < -6.0e-6, 1.0e20, 0.0)"
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.01
electrons.uy_th = 0.01
electrons.uz_th = 0.01
"""


@contextlib.contextmanager
def one_rank():
    """This process as a process group of one rank: NCCL carries the
    card's tensors, gloo the CPU's; NCCL's bootstrap binds the loopback
    interface.  Destroyed on the way out."""
    import os

    import torch.distributed as dist
    from warpx_tpu_torch.parallel.launch import init_single_rank

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    init_single_rank("cpu:gloo,cuda:nccl")
    try:
        yield
    finally:
        dist.destroy_process_group()


def deck_cfg(text):
    from warpx_tpu_torch.core.deck import config_from_deck
    from warpx_tpu_torch.utils.parser import Deck

    return config_from_deck(Deck.from_string(text))


def dist_sim(kind, cfg, device, dtype):
    """A one-rank DistSimulation over {"z": 1} or ParticleDistSimulation."""
    from warpx_tpu_torch.core.particle_dist import ParticleDistSimulation
    from warpx_tpu_torch.core.simulation import DistSimulation

    if kind == "dist":
        return DistSimulation(cfg, {"z": 1}, dtype=dtype, device=device)
    return ParticleDistSimulation(cfg, dtype=dtype, device=device)


def dist_parity_run(kind, cfg, device, balance):
    sim = dist_sim(kind, cfg, device, torch.float64)
    sim.init()
    if balance:
        sim.evolve(2)
        sim.load_balance()
        # one rank never adopts an assignment (nothing to gain): switch to
        # the balanced step and half push all the same
        sim._enter_balanced_mode()
    sim.evolve()
    return sim


def dist_parity_cases():
    """(name, kind, configuration, forced balance) of dist_parity."""
    return [("periodic_2d", "dist", deck_cfg(DIST_LANGMUIR_2D), False),
            ("periodic_3d", "dist", deck_cfg(DIST_THERMAL_3D), False),
            ("corner_balanced", "dist", deck_cfg(DIST_CORNER_3D), True),
            ("lwfa_32x64", "pdist", small_lwfa_cfg(), False),
            ("pec_16", "pdist", pec3d_cfg(), False)]


def phase_dist_parity(dev):
    """dist_parity: Queue A 14 in float64 on one rank, the card over NCCL
    against the CPU over gloo (one process group of both): the periodic
    2D and 3D decks of tests/test_torch_sharded.py through DistSimulation,
    the corner plasma of tests/test_load_balance.py after a load_balance()
    and a forced switch to the balanced step and half push, and the
    32 x 64 laser-wakefield and 16^3 PEC decks through
    ParticleDistSimulation (whose J all-reduce goes through NCCL):
    states slot by slot and checksums within 1e-9, no particle lost, no
    kernel launched (the JAX package runs these paths per particle)."""
    import torch.distributed as dist

    out = {}
    with one_rank():
        backend = str(dist.get_backend())
        for name, kind, cfg, balance in dist_parity_cases():
            before = kernel_counters()
            t0 = time.perf_counter()
            card = dist_parity_run(kind, cfg, dev, balance)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            launched = [a - b for a, b in zip(kernel_counters(), before)]
            cpu = dist_parity_run(kind, cfg, "cpu", balance)
            lost = int(card.state.aux.get("lost", 0))
            if card.binned or any(launched) or lost:
                raise AssertionError(f"dist_parity {name}: binned "
                                     f"{card.binned}, kernels {launched}, "
                                     f"lost {lost}")
            worst = states_agree(card, cpu, 1e-9, f"dist_parity {name}")
            worst_sum = checksums_agree(card.checksums(), cpu.checksums(),
                                        1e-9, f"dist_parity {name}")
            out[name] = {"kind": kind, "max_rel_err": worst,
                         "checksum_max_rel_err": worst_sum,
                         "balanced": bool(getattr(card, "_balanced", False)),
                         "alive": {nm: int(sp.alive.sum()) for nm, sp
                                   in card.state.species.items()},
                         "card_s": card_s}
    emit("dist_parity", ok=True, tol=1e-9, world=1, backend=backend,
         kernel_launches=0, cases=out)


def drive_timed(sim, steps):
    """init, a warm step, ``steps`` - 3 steps in one ``evolve`` call timed
    by CUDA events (a distributed simulation reads its ``lost`` count back
    once a call), one profiled step, the closing step; returns (host init
    s, ms a step, the profile)."""
    t0 = time.perf_counter()
    sim.init()
    sim.evolve(1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    sim.evolve(steps - 3)
    b.record()
    b.synchronize()
    breakdown = profile_steps(sim, PROFILED_STEPS_PER_PARTICLE)
    sim.evolve()
    torch.cuda.synchronize()
    return init_s, a.elapsed_time(b) / (steps - 3), breakdown


MAIN_DIST_STEPS = 8
# the checksums of uniform-128-dist against the single-card per-particle
# step in float32: the two sum J in another order (the guard fold against
# the periodic wrap, index_add_'s atomics in both)
TOL_DIST_F32 = 1e-3


def phase_main_dist(dev, smi, n=128, steps=MAIN_DIST_STEPS):
    """uniform-128-dist: main's plasma (bench.py::_build_sim at n = 128,
    8,388,608 particles, order 1, Yee, float32) through DistSimulation(cfg,
    {"z": 1}) on one rank over NCCL, per particle (the JAX package's
    sharded step is per particle): init (the host's distribute_state
    included), a warm step, ``steps`` - 3 timed steps, one profiled step,
    the closing step; one load_balance() timed alone; then the single-card
    per-particle Simulation of the same configuration driven the same way.
    Gates: lost = 0, every particle alive, finite fields, no kernel
    launched, the checksums within TOL_DIST_F32 of the single run's."""
    import warpx_tpu_torch

    cfg = dataclasses.replace(main_cfg(n, steps), tiled_particles="off")
    n_particles = 2 * 2 * n ** 3
    before = kernel_counters()
    with one_rank():
        sim = dist_sim("dist", cfg, dev, torch.float32)
        init_s, ms, prof = drive_timed(sim, steps)
        sim.assert_no_lost()
        lost = int(sim.state.aux["lost"])
        sums = sim.checksums()
        alive = sum(int(sp.alive.sum()) for sp in sim.state.species.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adopted = sim.load_balance()
        torch.cuda.synchronize()
        lb_ms = (time.perf_counter() - t0) * 1e3
        lb_eff = float(sim.state.aux["lb_efficiency"])
        finite = all(bool(torch.isfinite(getattr(sim.state.fields, nm)).all())
                     for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"))
        del sim
        torch.cuda.empty_cache()
    launched = [a - b for a, b in zip(kernel_counters(), before)]
    single = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    if single.binned:
        raise AssertionError("main_dist's reference took the binned step")
    s_init, s_ms, s_prof = drive_timed(single, steps)
    worst = checksums_agree(sums, single.checksums(), TOL_DIST_F32,
                            "main_dist")
    del single
    torch.cuda.empty_cache()
    if lost or alive != n_particles or not finite or any(launched):
        raise AssertionError(f"main_dist: lost {lost}, alive {alive} of "
                             f"{n_particles}, finite {finite}, kernels "
                             f"{launched}")
    emit("main_dist", ok=True, cell="uniform-128-dist", mesh={"z": 1},
         world=1, n_cell=cfg.geometry.n_cell, n_particles=n_particles,
         order=cfg.particle_shape, steps_timed=steps - 3, ms_per_step=ms,
         pushes_per_s=n_particles / (ms * 1e-3),
         init_s=init_s, device_busy_share=prof["device_busy_share"],
         lost=lost, load_balance_ms=lb_ms, load_balance_adopted=adopted,
         lb_efficiency=lb_eff, checksum_max_rel_err=worst,
         checksum_tol=TOL_DIST_F32, single_ms_per_step=s_ms,
         single_init_s=s_init,
         single_device_busy_share=s_prof["device_busy_share"],
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    emit("main_dist_profile", steps=PROFILED_STEPS_PER_PARTICLE, **prof)


MAIN_LWFA_PDIST_STEPS = 6


def phase_main_lwfa_pdist(dev, smi, steps=MAIN_LWFA_PDIST_STEPS):
    """lwfa2d-2048x8192-pdist: main_lwfa's configuration (bench.py's 2D
    laser-wakefield deck at 2048 x 8192, 44.7 M electrons, PML, window,
    antenna, continuous injection, beam, filter, order 3, float32) through
    ParticleDistSimulation on one rank over NCCL, per particle: driven as
    main_dist, then the J all-reduce of its deposit block alone (CUDA
    events); then the single-card per-particle Simulation driven the same
    way.  Gates: the live count the single run's exactly, finite fields,
    no kernel launched."""
    import warpx_tpu_torch

    cfg = dataclasses.replace(main_lwfa_cfg(steps=steps),
                              tiled_particles="off")
    before = kernel_counters()
    with one_rank():
        sim = dist_sim("pdist", cfg, dev, torch.float32)
        init_s, ms, prof = drive_timed(sim, steps)
        alive = sim.alive_count()
        st = sim.stepper
        block = [torch.zeros(st.big_shape, dtype=torch.float32, device=dev)
                 for _ in range(3)]
        st.shards.sum(block)
        reduce_ms = cuda_ms(lambda: st.shards.sum(block), 20)
        reduce_bytes = sum(t.numel() * t.element_size() for t in block)
        finite = all(bool(torch.isfinite(getattr(sim.state.fields, nm)).all())
                     for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"))
        window_lo = float(sim.state.aux["window_lo"])
        del sim, st, block
        torch.cuda.empty_cache()
    launched = [a - b for a, b in zip(kernel_counters(), before)]
    single = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    if single.binned:
        raise AssertionError("main_lwfa_pdist's reference took the binned "
                             "step")
    s_init, s_ms, s_prof = drive_timed(single, steps)
    alive1 = sum(int(sp.alive.sum()) for sp in single.state.species.values())
    del single
    torch.cuda.empty_cache()
    if alive != alive1 or not finite or any(launched):
        raise AssertionError(f"main_lwfa_pdist: alive {alive} against "
                             f"{alive1}, finite {finite}, kernels "
                             f"{launched}")
    emit("main_lwfa_pdist", ok=True, cell="lwfa2d-2048x8192-pdist", world=1,
         n_cell=cfg.geometry.n_cell, alive=alive, alive_single=alive1,
         steps_timed=steps - 3, ms_per_step=ms,
         pushes_per_s=alive / (ms * 1e-3), init_s=init_s,
         device_busy_share=prof["device_busy_share"],
         all_reduce_ms=reduce_ms, all_reduce_bytes=reduce_bytes,
         window_lo=window_lo, single_ms_per_step=s_ms, single_init_s=s_init,
         single_device_busy_share=s_prof["device_busy_share"],
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    emit("main_lwfa_pdist_profile", steps=PROFILED_STEPS_PER_PARTICLE, **prof)


def main() -> int:
    """Every phase in order."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from warpx_tpu_torch import build
    except ImportError as e:
        print(f"chip_smoke: the warpx_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    # every nvcc at the lowest priority while the per-particle paths, which
    # launch none of the kernels and keep the card busy, run beside them
    build.start_all(nice=19)
    meanwhile = (phase_main_lwfa_ionization, phase_main_qed,
                 phase_main_coulomb, phase_main_fusion, phase_main_mcc_dsmc,
                 phase_main_mr, phase_main_lwfa_mr, phase_main_rz_lwfa,
                 phase_main_rz_psatd, phase_main_dist, phase_main_lwfa_pdist)
    for phase in meanwhile:
        phase(dev, smi)
        torch.cuda.empty_cache()
    secs = build.build_all()
    regs = {nm: [ln.strip() for ln in build.build_log(nm).splitlines()
                 if "registers" in ln or "spill" in ln][:8]
            for nm in build.SOURCES}
    reports = {nm: ptxas_report(build.build_log(nm)) for nm in build.SOURCES}
    emit("build", ok=True, seconds=max(secs.values()),
         wall_s=time.perf_counter() - t0, per_library=secs,
         phases_meanwhile=[f.__name__[len("phase_"):] for f in meanwhile],
         ptxas=regs,
         registers={nm: sorted(set(r.values()))
                    for nm, (r, _) in reports.items()},
         spill_bytes={nm: sum(sp.values()) for nm, (_, sp) in reports.items()})
    phase_kernel_parity(dev, "k1_parity", 3, 16)
    phase_kernel_parity(dev, "k2_parity", 2, 32)
    phase_k1d_parity(dev)
    phase_k1c_parity(dev)
    phase_k3_parity(dev)
    phase_lab_parity(dev)
    phase_slice_parity(dev, "slice_parity", 3)
    phase_slice_parity(dev, "slice2d_parity", 2)
    phase_bounded_parity(dev)
    phase_deck_parity(dev)
    phase_psatd_parity(dev)
    variants = phase_psatd_variants_parity(dev)
    phase_boosted_parity(dev)
    phase_stochastic_parity(dev)
    phase_collision_parity(dev)
    phase_injection_parity(dev)
    phase_es_parity(dev)
    phase_fieldsolver2_parity(dev)
    phase_boundaries_parity(dev)
    dims1 = phase_dims1_parity(dev)
    phase_mr_parity(dev)
    phase_rz_parity(dev)
    phase_dist_parity(dev)
    k1_row, k3_row = phase_main(dev, smi)
    k1_row["launches_by_path"] = {"main": k1_row["launches"]}
    phase_main_psatd(dev, smi, k1_row, k3_row)
    torch.cuda.empty_cache()
    phase_main_psatd_galilean(dev, smi)
    torch.cuda.empty_cache()
    phase_main_psatd_multij(dev, smi)
    torch.cuda.empty_cache()
    k1d_rows = phase_main_mixed(dev, smi, k3_row)
    k2_row = phase_main2d(dev, smi, k3_row)
    k2_row["launches_by_path"] = {"main2d": k2_row["launches"]}
    # the tile-binned runs of psatd_variants_parity (not in ``launches``,
    # which counts the main paths)
    for row, nm in ((k1_row, "fused_pic"), (k2_row, "fused_pic_2d"),
                    (k3_row, "ragged_expand")):
        row["launches_by_path"]["psatd_variants_parity"] = variants[nm]
    # the runtime attributes' tile-binned runs of dims1_parity (K1c: below)
    k2_row["launches_by_path"]["dims1_parity"] = dims1["fused_pic_2d"]
    k3_row["launches_by_path"]["dims1_parity"] = dims1["ragged_expand"]
    torch.cuda.empty_cache()
    k1c_row = phase_main_lwfa(dev, smi, k2_row, k3_row)
    k1c_row.setdefault("launches_by_path", {})["dims1_parity"] = dims1[
        "fused_pic_2d_window"]
    torch.cuda.empty_cache()
    k1c_mixed_row, waits = phase_main_lwfa_deck(dev, smi, k3_row)
    torch.cuda.empty_cache()
    phase_main_lwfa_diags(dev, smi, k1c_mixed_row, k3_row, waits["idle"])
    torch.cuda.empty_cache()
    phase_main_lwfa_psatd(dev, smi, k1c_mixed_row, k3_row)
    torch.cuda.empty_cache()
    boosted_ms = phase_main_lwfa_boosted(dev, smi, k1c_mixed_row, k3_row,
                                         waits["idle"])
    torch.cuda.empty_cache()
    phase_main_lwfa_boosted_galilean(dev, smi)
    torch.cuda.empty_cache()
    phase_main_divclean(dev, smi)
    torch.cuda.empty_cache()
    phase_main_schwinger(dev, smi)
    torch.cuda.empty_cache()
    phase_main_resampling(dev, smi, k1_row, k3_row)
    torch.cuda.empty_cache()
    phase_main_flux(dev, smi)
    torch.cuda.empty_cache()
    phase_main_lwfa_lasy(dev, smi, k1c_mixed_row, k3_row)
    torch.cuda.empty_cache()
    phase_main_shape4(dev, smi)
    torch.cuda.empty_cache()
    phase_main_es(dev, smi)
    torch.cuda.empty_cache()
    phase_main_es_open(dev, smi)
    torch.cuda.empty_cache()
    phase_main_hybrid(dev, smi)
    torch.cuda.empty_cache()
    phase_main_macroscopic(dev, smi)
    torch.cuda.empty_cache()
    phase_main_lwfa_boosted_nci(dev, smi, k1c_mixed_row, k3_row, boosted_ms)
    torch.cuda.empty_cache()
    phase_nci_drift(dev, smi)
    torch.cuda.empty_cache()
    phase_main_implicit(dev, smi)
    torch.cuda.empty_cache()
    phase_main_implicit_jfnk(dev, smi)
    torch.cuda.empty_cache()
    phase_main_fluid(dev, smi)
    torch.cuda.empty_cache()
    phase_main_ect(dev, smi)
    torch.cuda.empty_cache()
    phase_main_eb(dev, smi)
    torch.cuda.empty_cache()
    phase_main_walls(dev, smi, k1_row, k1c_row, k3_row)
    torch.cuda.empty_cache()
    phase_main_silver_mueller(dev, smi)
    torch.cuda.empty_cache()
    phase_main_collocated(dev, smi)
    torch.cuda.empty_cache()
    phase_main_beamline(dev, smi)
    torch.cuda.empty_cache()
    phase_main_lwfa_warm(dev, smi, k1c_mixed_row, k3_row,
                         waits["ms_per_step"])
    torch.cuda.empty_cache()
    phase_main_1d(dev, smi)
    phase_main_lwfa_1d(dev, smi)
    lab_rows = phase_labs(dev)
    print(smi)
    print(json.dumps({"kernels": [k1_row, *k1d_rows, k2_row, k1c_row,
                                  k1c_mixed_row, k3_row, *lab_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
