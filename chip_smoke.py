"""Smoke run of the PyTorch port (ngmix_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths on the card, bench.py's metacal_gaussmom
workload, its exp-LM headline and its metacal_admom workload at the
production chunk size, the azgauss, fitgauss and dilate psf modes, its
multi-band workload, its pre-psf moments (standalone and as the pgauss
and ksigma metacal measures), its single-gaussian EM, the gauss and
dev LM models, the bdf and bd bulge+disk models, the
prior-regularized exp and bdf fits, the LM options (variable
projection, sheared-type refinement), the scale-out path (ragged
catalogs, checkpoints, a process group) and the single-object host
API (the admom, gaussmom, pre-psf and EM fitters, GMix.make_image, and
the LM fitters Fitter, CoellipFitter and PSFFluxFitter);
and holds the hand-written CUDA
kernels K2 (mixture evaluation), K1 (LM normal
equations), K3 (every lane's whole LM solve of the exp, gauss, dev, bdf
or bd model, and its refine and varpro modes) and K3-mb (every object's
joint multi-band solve) against their plain PyTorch versions. The exp-LM path
runs through K3; its host-loop route (run_lm_normal_batched with K1,
reached through _exp_lm_measure's host_loop argument) is driven for the
phases that hold K1 and for the comparison. Phases, in order, each
printing one timed line as soon as it ends:

1. card:   the card's name and power limit (nvidia-smi);
2. build:  nvcc builds every kernel (K1, K2, K3 with its modes, K3-mb)
           into build/ngmix_tpu_torch/ (first use), one library a
           source, in the background from the start: one nvcc process a
           core, the sources of phases 3-18 first (EARLY_UNITS), then
           the costliest first; meanwhile the residual LM runs once on
           the card (warm_run_lm) and the card sides of phases 3-17 run,
           each kernel call waiting for its own source; the CPU sides
           start when the last source has started. The line is printed
           when the build has ended (before phase 18), with its wall
           seconds and each unit's nvcc CPU seconds and wall span;
3. kernel: K2 against its plain version on the same CUDA inputs over
           n in {1, 6} (compile-time) and {3, 18} (any n), both modes,
           float32 and float64, B in {1, 3, 10243} (10243 leaves a
           ragged last tile at every P) and P in {1, 361, 625, 1000,
           2401}, with a degenerate gaussian, in four layouts: area a
           [B, P] tensor, area a scalar, v, u and area contiguous views
           at a one-element offset (the plain-load head), and only v at
           that offset (every tile by plain loads); rtol 1e-12 in
           float64, and in float32 rtol 1e-5 with an atol of 1e-6 times
           the lane's max |model|. Then K2 bitwise equal on a permuted
           and truncated batch, also at a one-element offset;
4. main:   the gaussmom metacal pipeline in float32 on the port's
           homogeneous and heterogeneous sims at B = 10240, gated like
           bench.py: |m| < 1e-3, |hetero m| < 1e-3, flagged lanes
           <= max(8, 0.5% B), and K2 launched;
5. cpu:    the first 256 stamps in float64 on the card and on the CPU:
           flags equal, pars and s2n to rtol 1e-8 and atol 1e-10;
6. times:  K2 at the main path's two shapes (n = 1 over [5 B, 361]
           with a [B, P] area, n = 18 over [B, 2401] with a scalar
           area), held against its plain version there at phase 3's
           tolerances, and timed beside its bound, with the kernel's
           registers a thread, shared memory, blocks an SM and grid;
7. k1:     K1 against its plain version on the same CUDA inputs over
           n in {1, 6, 10}, float32 and float64, B in {1, 3, 10240}
           and P in {361, 1000, 1089}, with an invalid gaussian in one
           lane: in float64 cost to rtol 1e-10, Jtr and JtJ to rtol
           1e-8 with an atol of 1e-8 times the largest |value|
           (tests/test_pallas_lm.py:65-73); in float32 cost to rtol
           1e-5, Jtr and JtJ to rtol 1e-5 with an atol of 1e-5 times
           their Cauchy-Schwarz scale, sqrt(JtJ_kk cost) for Jtr_k and
           sqrt(JtJ_kk JtJ_mm) for JtJ_km, which bounds the sum of the
           absolute terms float32 rounds (the signed sums cancel);
8. exp-lm: the exp-LM metacal pipeline (through K3) in float32 on the
           homogeneous and heterogeneous sims at B = 10240 (5 B = 51200
           lanes), gated like bench.py: |m| < 1e-3, |hetero m| < 1e-3,
           flagged lanes <= max(8, 0.5% B), e1 equal to pars[:, 2] bit
           for bit, and K3 and K2 launched; prints the launches of K3,
           K1 and K2 over those two calls, nfev and the fraction of
           lanes frozen at their guess (flags 0, nfev <= 2, pars equal
           to the guess); both selection estimators on those results
           with a cut that never binds (s2n > -1): R_sel 0 and shear
           equal to shear_response's to rtol 1e-10;
9. lm-cpu: the host-loop route on the first 256 stamps in float64 on
           the card and on the CPU: flags equal, e1/e2/T/flux to rtol
           1e-5 and atol 1e-7, nfev within 2
           (tests/test_pallas_lm.py:107-123);
10. compact: the host-loop route at B = 2048 (10240 lanes) with the
           automatic compaction cascade and without: pars, flags, nfev,
           ier and cost bitwise equal;
11. k-times: K1 at its main-path shape (n = 6 over [5 B, 361], float32,
           the inputs of the host-loop route's first normal-equation
           call) and K2 at the exp-LM path's shape (n = 6, fast, over
           [5 B, 361], the inputs of get_loglike's call), each held
           against its plain version (K1 in float32: cost to rtol 1e-3,
           Jtr and JtJ to rtol 1e-3 with an atol of 1e-4 times their
           Cauchy-Schwarz scale, since the residual f ia - ve cancels to
           the noise level at a peak signal-to-noise of ~1e3; K2 at
           phase 3's tolerances) and timed beside its bound, with
           K2's and K3's registers a thread, shared memory and blocks an
           SM;
12. k3:    K3 in float64 at B = 2048 (10240 lanes), per lane flags
           equal, e1/e2/T/flux to rtol 1e-5 and atol 1e-7 and nfev
           within 2: the pipeline's K3 and host-loop routes, K3 against
           its plain version on the solve's own inputs, and a bounded
           case (finite lo and hi, pinned dims) at 256 synthetic stamps
           against run_lm_normal_batched with the same bounds; then K3
           on full 49x49 stamps (P = 2401, the planes read from global
           memory): 64 lanes of the sims from seed 1 (the reference's
           README input) against its plain version by this criterion,
           and 2048 of the main path's stamps (10240 lanes) in float32
           by phase 13's criterion, timed beside its bound;
13. k3-times: K3 at its main-path shape (float32, the pipeline's own
           solve inputs) against its plain version: flags equal on
           every lane, and on every lane that both leave unflagged
           e1/e2/T/flux within half the lane's statistical error
           (pars_err): float32 LM runs stop within their ftol
           tolerance of the optimum, and two of them agree to a
           fraction of the error, not to a fixed rtol (e2 is ~0 on
           these sims); phase 12 holds float64 to the reference
           tolerances. The share of lanes outside rtol 1e-4 is printed.
           Then K3 bitwise equal on a permuted and truncated batch,
           timed beside its bound and its plain version; then the
           exp-LM call by the K3 and the host-loop routes, N_TIMED
           calls each interleaved (median and range) with the span
           between CUDA events recorded at a call's start and end (a
           call's device operations, busy time and idle share come from
           python -m ngmix_tpu_torch.profile_main_path). The host-loop
           route's first timed call and one
           call on the het sims are gated like phase 8 (and K1's
           launches over them printed), and the share of its float32
           lanes whose e1/e2/T/flux differ from the K3 route's by more
           than rtol 1e-4, with the largest difference in units of
           pars_err, is printed;
14. admom: the admom metacal pipeline (bench.py's metacal_admom
           configuration) in float32 on the homogeneous and
           heterogeneous sims at B = 10240 (5 B = 51200 lanes), gated
           like phase 4, with K2 launched and one call launching K2
           twice an iteration and once more; prints numiter (mean, p50,
           max), the host loop's iterations a call, stamps/s (median
           and range of 3 calls) and the CUDA-event span of a call (its
           device operations and idle share come from
           profile_main_path);
15. admom-cpu: the first 256 stamps in float64 on the card and on the
           CPU: flags and numiter equal, every field to rtol 1e-8 and
           atol 1e-10 with NaNs in the same places;
16. admom-batch: bench.py's standalone admom shape, admom_batch on
           B = 10240 full 49x49 stamps from a round T = 0.6 guess
           (flags, numiter, stamps/s); K2 at admom's two shapes (n = 1,
           fast, over [5 B, 361] with a [B, P] area and over [B, 2401]),
           on the inputs of each path's first weight, held against its
           plain version at phase 3's tolerances and timed beside its
           bound, with its launches a call at that shape;
17. psf-modes: at B = 10240 in float32 on both sims, gaussmom under
           fitgauss, azgauss and dilate (all 9 types, with the
           psf-sheared ones), and admom and exp-LM (through K3) under
           dilate: flagged lanes within phase 4's bound, K2 (and K3)
           launched, fitgauss |m| < 1.5e-3, and under dilate
           psf_shear_response finite, for gaussmom with diagonal > 0.02
           and |off-diagonal| < 0.5 x diagonal
           (tests/test_batch_pipeline.py:474-480); K3 against its plain
           version on the dilate exp-LM solve's own inputs (an
           elliptical psf per lane) by phase 13's criterion; K2 on the
           psf-stamp admom weight of the fitgauss gaussmom call (n = 1,
           fast, [B, 625]) and of the dilate exp-LM call ([9 B, 625],
           the nine types' rendered targets), each held against its
           plain version and timed as in phase 16; then the
           first 256 stamps of each run in float64 on the card and the
           CPU: psf_sigma and every field of the moments measures to
           rtol 1e-8 as in phase 15, exp-LM by phase 12's criterion;
18. mb:    bench.py's multi-band workload, metacal_pipeline_mb at B = 2048
           objects x E = 3 epochs (every epoch a copy, band [0, 0, 1],
           nband = 2), exp-LM through K3-mb at pad 2 in float32 on both
           sims, gated like phase 8 (|m|, |hetero m| < 1e-3, flagged <=
           max(8, 0.5% B), e1 equal to pars[:, 2]) with K3-mb launched
           once a call and K2 launched; objects/s and epoch-stamps/s
           (median and range of 3 calls), the event span and nfev.
           Then: the flat exp-LM (through K3) on
           the same stamps, whose optimum the joint fit shares: the share
           of lanes whose e1/e2/T differ by more than half the flat
           pars_err, and both band fluxes within half the flat flux
           error; K3-mb against its plain version on the main path's
           solve inputs by phase 13's criterion, bitwise on a permuted
           and truncated batch, at E = 8 over 64 objects (E P = 2888,
           past shared memory) in float64 by phase 12's criterion, and
           at E = 1 and one band against K3 by phase 12's criterion; 256
           objects whose epochs are not copies, with a per-object band
           map, in float64 on the card and the CPU (flags equal, nfev
           within 2, pars and s2n to rtol 1e-8 and atol 1e-10); K3-mb
           and K2 at the mb shapes timed beside their bounds;
19. prepsf: bench.py's pre-psf moments, prepsfmom_batch (ksigma, FWHM
           2.0, target_dim 196, tot_var = NOISE^2, partial modes) on
           B = 10240 49x49 sim stamps in float32: stamps/s (median and
           range of 3 calls), the event span, T finite and
           kernel_nrm within 1e-5 of 1; the pgauss and ksigma metacal
           pipelines (the gaussmom fields, FWHM 2.0) at B = 10240 with
           the reference's gate, |m| < 1.5e-3, 1.1 < R11 < 1.8
           (tests/test_batch_pipeline.py:223-240), flagged <= max(8,
           0.5% B) and K2 launched once a call (the round target psf
           render), and pgauss under dilate with |m| < 3e-3 (:491-503);
           K2 on the psf render's inputs (n = 1, exact, [B, 625],
           scalar area) held against its plain version and timed; then
           256 stamps in float64 on the card and the CPU for pgauss and
           ksigma by both routes, with white and measured noise: flags
           equal, sums and covariance to rtol 1e-10 and atol 1e-13
           (tests/test_prepsfmom.py:226); and remap_k at N = 520 (the
           chirp-z route) card against CPU in float64 to 1e-10;
20. em:    bench.py's em1 workload, em_batch of one gaussian on the
           sky-shifted stamps (sims.em1_inputs) at B = 10240 with the
           default EMConf in float32: flagged lanes, numiter (mean,
           p50, p90, p99, max), stamps/s (median and range of 3 calls),
           the event span; then 256
           stamps in float64 on the card and the CPU: flags and numiter
           equal, gmix, gmix_conv and sky to rtol 1e-8 and atol 1e-10;
21. models: the gauss-lm and dev-lm metacal pipelines (through K3) at
           bench.py's exp-LM configuration in float32 on both sims at
           B = 10240: |m|, |hetero m| < 1e-3 for gauss and < 3e-3 for
           dev (the reference's bound for a misspecified model,
           tests/test_batch_pipeline.py:304-318), flagged <= max(8,
           0.5% B), K3 launched once a call and K2 launched, stamps/s
           (median and range of 3 calls) and nfev; K3 at NG = 1 and 10
           on each path's solve inputs against its plain version by
           phase 13's criterion, on 256 of them in float64 by phase
           12's, and timed beside its bound; K3-mb at NG = 1 and 10 on
           phase 18's solve inputs by phase 13's criterion, timed; K2
           at dev's s/n sums (n = 10, fast, [5 B, 361]) held against its
           plain version and timed; card against CPU in float64 on 256
           stamps: exp-LM in the reference's bounds box
           (tests/test_batch_pipeline.py:394-395; flags equal, nfev
           within 2, pars to rtol 1e-8 and atol 1e-10, inside the box)
           and the mb pipeline with gauss-lm and dev-lm as in phase 18
           (N_CPU_MB_MODELS objects);
22. composite: bdf-lm inside its production bounds
           (tools/validate_scale.py:391-411, fracdev in [0, 1], flux in
           [1e-3, 1e9]) and bd-lm inside the reference's box
           (tests/test_batch_pipeline.py:366-367) through K3 at bench.py's
           exp-LM configuration in float32 at B = 10240 on the exp sims
           (fracdev on its bound) and the heterogeneous bdf-truth sims
           (sims.make_sim_batch_hetero(gal_model="bdf")): |m|, |hetero
           m| < 1e-3 for bdf and < 3e-3 for bd (the reference's bound,
           :372), flagged <= max(8, 0.5% B), e1 equal to pars[:, 2], K3
           launched once a call and K2 launched, stamps/s and nfev; the
           mb pipeline with both models (the boxes' flux bounds repeated
           a band, tools/validate_scale.py:436-442) through K3-mb on the
           mb exp and bdf-truth sims at 2048 x 3, gated the same, K3-mb
           once a call; K3 at bdf and bd on the bdf-truth path's solve
           inputs against its plain version by phase 13's criterion,
           timed beside its bound (the operations recounted for 7 and 8
           parameters, k3_ops) with its registers and local memory, and
           K3-mb at both on the mb bdf-truth path's inputs the same way,
           with its local memory at nband 1-6. On the exp sims ROADMAP
           fault 3.4 shows (float32 solves of K3 and its plain version
           alike stop early on rare lanes; float64 solves part in nfev
           where the fracdev pin toggles at a near-tie), so the checks
           there count such lanes against stated limits (F32_LIMIT,
           f64_lanes): K3 and K3-mb on the exp paths' solve inputs in
           float32 against their own float64 solves, and on 256 lanes of
           every path in float64 against their plain versions; K2 at
           bdf's s/n sums (n = 16, fast, [5 B, 361]) against its plain
           version and timed; card against CPU in float64 by f64_lanes,
           bdf on phase 21's inputs (the first N_CPU_COMPOSITE exp
           stamps, and 86 objects of 3 epochs that are not copies with
           the per-object band map of phase 18) and bd, degenerate on
           exp truth, on the bdf-truth sims (the same shapes);
23. priors: exp-lm with the reference test's PriorSimpleSep and box
           (tests/test_batch_pipeline.py:389-397) on the exp sims, and
           bdf-lm with the production PriorBDFSep (tests/_priors.py:
           16-32) under sims.BDF_LM_BOUNDS on the exp and bdf-truth
           sims, flat through K3 and mb (nband 2) through K3-mb, at
           B = 10240 (mb 2048 x 3) in float32, gated (|m|, |hetero m| <
           1e-3 for exp, < 3e-3 for bdf; flagged <= max(8, 0.5% B)),
           one K3 or K3-mb launch a call; K3 and K3-mb with the prior
           rows on every path's float32 solve inputs against their own
           float64 solve (lanes beyond half a pars_err counted against
           PRIOR_F32_LIMIT) and on 256 lanes in float64 against their
           plain versions (flags equal, e1/e2/T/flux to rtol 1e-5 and
           atol 1e-7, nfev within 2, at most PRIOR_F64_LIMIT lanes
           outside), cost_pix checked against the rows; timed with and
           without the prior beside their bounds (prior_ops counts the
           rows' operations); card against CPU in float64 by f64_lanes
           on 256 exp stamps, 256 bdf-truth stamps and 256 mb objects
           of distinct bdf-truth epochs;
24. options: the LM options at B = 10240 in float32 on the exp sims:
           exp-lm with LMConf(varpro=True) (K3's varpro mode), exp-lm and
           bdf-lm in sims.BDF_LM_BOUNDS (fracdev on its bound) with
           sheared_refine=3 (K3 on the noshear lanes, then K3's refine
           mode), each gated like phase 8 (|m|, |hetero m| < 1e-3,
           flagged <= max(8, 0.5% B)) with its launches (one K3 mode
           launch a call), its largest |g1| difference from the full-LM
           call and its time beside the full-LM call's (median of 3);
           exp-lm with flux_col=True bitwise equal to the default; each
           mode against its plain version on the first 256 lanes of its
           solve inputs in float64 (flags equal, e1/e2/T/flux to rtol
           1e-5 and atol 1e-7, nfev within 2), and in float32 on the
           first PLAIN_LANES lanes (flags equal; unflagged e1/e2/T/flux
           within half a pars_err, on bdf but on at most fault 3.4's
           lanes, OPTION_F32_LIMIT), and timed at the full shape
           beside its bound (VALUE_OPS and k3_ops a value pass and an
           evaluation) and its plain version, with its registers; the
           three option pipelines card against CPU in float64 on 256
           stamps by f64_lanes;
25. scale-out: metacal_pipeline_ragged (exp-lm, float32) on a catalog
           of 512 single-epoch 49x49 stamps and 512 objects of 41x41
           crops with one or two epochs (a pad epoch): each bucket's rows
           equal to its direct pipeline call; the results written as two
           checkpoint shards, resumed at index 1 and read back equal;
           a one-process NCCL group: the sharded flat (512 stamps) and mb
           (128 objects) pipelines' rows and calibration equal to the
           unsharded calls';
26. host:  the single-object host API in float64 on the card, on the
           first stamps of the sims (seed HOST_SEED) as Observations with
           their psf stamps: AdmomFitter.go on 64 objects from guesses
           drawn in numpy, GaussMom.go on 64, PGaussMom and KSigmaMom
           (FWHM 2.0) on 16 and EMFitter.go (one round gaussian, the delta
           psf) on 8, each object held to its row of one admom_batch,
           gaussmom_measure, prepsfmom_batch or em_batch call on the same
           stamps and guesses (flags and numiter equal, rtol 1e-10 and
           atol 1e-12; pre-psf rtol 1e-10, atol 1e-13,
           tests/test_prepsfmom.py:226), with K2 launched
           2 numiter + 1 times an admom object and once a gaussmom object,
           counted from 0 over the host run; GMix.make_image of an exp
           mixture (n = 6), exact and fast, against its CPU render at rtol
           1e-12 with an atol of 1e-12 of the peak; K2 at the host shapes
           (one lane of 2401 pixels, n = 1 and 6) against its plain
           version and timed; each fitter's ms an object, beside the
           card's name and power limit;
27. fitters: the host LM fitters in float64 on 49x49 stamps made from
           numpy (seed FIT_SEED) with gauss psf mixtures: Fitter("exp").go
           on 64 objects and on 16 two-band objects, Fitter("bdf") with
           the production PriorBDFSep on 8, Fitter("gauss") on 8 psf
           stamps without a psf (K3 with a zero psf), CoellipFitter(3) on
           8 psf stamps and Fitter("exp") on 8 objects under a
           two-gaussian psf (run_lm), PSFFluxFitter on 8: every fit's
           route asserted; K3 launched once a fit of the K3 route and
           K3-mb once a fit of the K3-mb route, counted from 0, and
           neither by the other fits; every fit held to the same fit on
           the CPU (flags equal, pars, pars_err and s2n to rtol 1e-5 and
           atol 1e-7, nfev within 2); K3 and K3-mb at B = 1 on one fit's
           inputs against their plain versions and timed beside their
           bounds; ms an object of each group, beside the card's name and
           power limit.
28. bootstrap: the host metacal bootstrap and the k-space fitters in
           float64 on stamps made from numpy (a seed a group): the
           reference's shear oracle (tests/test_metacal.py:204-249) on 16
           objects, MetacalBootstrapper(psf="gauss", types noshear, 1p,
           1m) with Runner(GaussMom(1.2)) and PSFRunner(Fitter("gauss"),
           SimplePSFGuesser(guess_from_moms=True), ntry=3): flags 0,
           |m| < 1e-3; MetacalBootstrapper with Runner(Fitter("exp"),
           TFluxGuesser) under psf="fitgauss" on 8 objects and "dilate"
           (all nine types) on 4; KSpaceFitter gauss and exp,
           GalsimSpergelFitter, GalsimMoffatFitter and
           GalsimPSFFluxFitter on 4 objects each, on the stamps and from
           the guesses of the reference's tests/test_kspace_fitters.py:
           every fit's route K3,
           every result held to the same run on the CPU (moments rtol
           1e-10 + atol 1e-12, LM fields rtol 1e-5 + atol 1e-7 and nfev
           within 2, flags equal), the first object's metacal images of
           each psf mode to rtol 1e-8 + atol 1e-10 of the peak; K3 and
           K2 launches counted from 0 equal to the K3-route fits and to
           the GaussMom, admom, s/n-sum and moments-guess calls
           (counted_fits), none by the k-space fits; ms an object of each
           group, beside the card's name and power limit.
29. host-api: the rest of the host API in float64 on the card, each
           result against the CPU's: Fitter("exp") with a PriorSimpleSep
           of LMBounds slots, its bounds the prior's, on 4 objects (K3),
           CoellipFitter(3) with PriorCoellipSame on 4 psf stamps,
           KSpaceFitter("spergel") with PriorSpergelSep and
           KSpaceFitter("exp") with PriorGalsimSimpleSep on 2 objects each
           (phase 28's k-space stamps and guesses; seed API_SEED), routes
           and launches counted (phase 27's criterion); a MEDS object
           (ScriptMEDS, in memory) read on the card and fitted (K3);
           GMixND.get_lnprob_array over 10^6 rows of a 3-d mixture of 8
           gaussians that GMixND.fit made from 10^5 samples (the mixture
           they are drawn from where sklearn is absent), timed with
           profiling.timed and its sync, and get_gaussap_flux over 10^6
           bdf objects in 3 bands, rtol 1e-12, flags equal. Phase 23 also
           runs exp-lm and the mb bdf-lm with LMBounds slots through K3
           and K3-mb (the LMBounds kind of the prior table), gated and
           held to the plain versions as its other priors.
The float64 CPU sides of phases 5, 9, 15, 17-24 and 26-29 run in
CPU_WORKERS spawned processes of one thread each (at nice 10) from the
moment the build's last source has started, while the card runs the
phases before them (the checks of phases 5, 9, 15 and 17 wait for the
build's end): each job's lanes
split over the workers, so that they take the jobs in the order the
phases read them. Before the JSON result the timing line gives each
phase line's own seconds ("2 build" the wait for the build's end before
phase 18), the build's wall seconds and the seconds the phases waited
for the CPU sides.
Needs one CUDA card and exits nonzero, printing the reason, on any
failure or without a card. The last line is the JSON result.
"""
import contextlib
import functools
import json
import subprocess
import multiprocessing
import os
import sys
import time
from unittest import mock

import numpy as np
import torch

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import joint_prior, priors as tpriors, profiling
from ngmix_tpu_torch.fitting import fit_model, lm as tlm
from ngmix_tpu_torch.gmix import core as gcore
from ngmix_tpu_torch.gaussmom import make_weight_gmix
from ngmix_tpu_torch.ops import _build, gmix_eval, lm_solve, normal_eqs

B_MAIN = 10240
B_COMPACT = 2048
B_BOUNDED = 256
N_TIMED = 3
# launches a K3 or K3-mb time takes the mean of (after two warm-ups)
K3_TIMED = 3
NTYPES = 5
CONF = nt.sims.METACAL_GAUSSMOM_CONFIG
ADMOM_CONF = nt.sims.METACAL_ADMOM_CONFIG
LM_CONF = nt.sims.METACAL_EXP_LM_CONFIG
# the exp-LM configuration on the full 49x49 stamps (no fit window)
FULL_CONF = LM_CONF._replace(fit_dims=None)
SHEAR_TRUE = nt.sims.SHEAR_TRUE
B_MB = 2048
MB_CONF = nt.sims.METACAL_MB_CONFIG
# the float64 card-against-CPU checks of the LM measures (phases 18,
# 21 and 22): 256 flat stamps, 256 mb objects of 3 epochs, and 86 (258
# epoch stamps) for the mb composite models (N_CPU_MB_MODELS and
# N_CPU_COMPOSITE below for phases 21 and 22); their CPU sides run in
# CPU_WORKERS processes of one thread each while the card works
N_CPU = 256
N_CPU_MB = 256
# the lanes of phases 21-24's float32 solve inputs on which K3 (and its
# modes) and K3-mb are held against their plain versions, whose time is
# taken there: the first B_MAIN (mb: B_MB object-lanes), the noshear
# type's; phases 13 and 18 hold every lane (the kernels line's rows)
PLAIN_LANES = B_MAIN
PLAIN_LANES_MB = B_MB
N_CPU_MB_COMPOSITE = 86
# the CPU sides costliest a lane, at half depth: phase 21's mb gauss-lm
# and dev-lm (objects) and phase 22's flat bdf-lm and bd-lm (stamps)
N_CPU_MB_MODELS = 128
N_CPU_COMPOSITE = 128
# with the main process, every core of an H100 host's 8
CPU_WORKERS = 7

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# K2's arithmetic per (pixel, gaussian): offsets 2, chi2 9, exponent
# scale 1, exp 1, pnorm product 1, accumulate 1; plus the area product
# per pixel
OPS_PER_PIXEL_GAUSS = 15
# K1's arithmetic, counted from csrc/normal_eqs.cu with a fused
# multiply-add as 2 operations and an exp as 1: per (pixel, gaussian)
# the offsets and chi2 (11); per pair inside the window [0, 25) the
# exponential and its argument, the value, f, c, the six derivatives and
# the 36-term chain product (92); per pair in the apodized band
# (20, 25] the window and its derivative (14); per pixel the residual,
# the weighted J and the 28 running sums (64)
K1_OPS = (11, 92, 14, 64)
# the gaussians of the LM models (gmix/tables.py; bdf and bd: fill_cm)
NGAUSS = {"exp": 6, "gauss": 1, "dev": 10, "bdf": 16, "bd": 16}


def k3_ops(npars):
    """K3's arithmetic per evaluation of a model of npars = 6 + NX
    parameters (NX extra shape columns: 0, bdf's 1, bd's 2), counted
    from csrc/lm_common.cuh as K1_OPS is: per (pixel, gaussian) the
    offsets and chi2 (11); per pair inside the window the exponential
    and its argument, the windowed value and f (5), c (4), the five d
    value / d q (11) and the closed-form chain into J (four
    multiply-adds, 8, for each of the 3 + NX shape parameters, an add
    each for row and col, a multiply-add for the flux: 28 + 8 NX), 48 +
    8 NX in all; per pair in the apodized band the window and its
    derivative (14); per pixel the residual (2), the weighted J (npars), the cost (2) and
    the Jtr and JtJ sums (2 npars + npars (npars + 1)): 64 at npars = 6.
    The per-gaussian set-up, the shuffle tree and the step algebra,
    under 1% of an evaluation, are left out"""
    nx = npars - 6
    return (11, 48 + 8 * nx, 14, 4 + 3 * npars + npars * (npars + 1))


class SmokeFailure(Exception):
    pass


# each phase line's end (time.perf_counter()) and the seconds each phase
# waited for CpuSide's results: the timing line before the last line of
# the output
PHASE_ENDS = {}
CPU_WAITS = {}


def phase_line(name, t0, msg=""):
    now = PHASE_ENDS[name] = time.perf_counter()
    print("[%s] %.2f s %s" % (name, now - t0, msg), flush=True)


def timing_line(t_all):
    """each phase line's own seconds (from the end of the line before it,
    the first from t_all; "2 build" is the wait for the build's end
    before phase 18), the build's wall seconds, the seconds the phases
    waited for the CPU sides and the run's total"""
    own, prev = [], t_all
    for name, end in PHASE_ENDS.items():
        own.append("%s %.1f" % (name, end - prev))
        prev = end
    return "timing: %s; build wall %s; cpu waits %s; total %.1f s" % (
        ", ".join(own),
        "%.1f s" % BUILD_SECONDS["wall"] if "wall" in BUILD_SECONDS else "none (built before)",
        ", ".join("%s %.1f" % kv for kv in CPU_WAITS.items() if kv[1] >= 0.05) or "none",
        time.perf_counter() - t_all)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _random_case(gen, B, n, P, dtype, degenerate):
    """[B, n, 6] mixtures with spread sizes and shapes over [B, P]
    coordinates; optionally a gaussian with det <= 0 and T <= 0 in the
    last lane"""
    dev = gen.device

    def U(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype) * (hi - lo) + lo

    T = U((B, n), 0.05, 3.0)
    e1 = U((B, n), -0.4, 0.4)
    e2 = U((B, n), -0.4, 0.4)
    gm = torch.stack(
        [U((B, n), 0.1, 2.0), U((B, n), -0.5, 0.5), U((B, n), -0.5, 0.5),
         0.5 * T * (1 - e1), 0.5 * T * e2, 0.5 * T * (1 + e1)],
        dim=-1,
    )
    if degenerate:
        gm[-1, 0, 3:] = torch.tensor([-0.5, 0.6, -0.5], dtype=dtype)
    v = U((B, P), -3.5, 3.5)
    u = U((B, P), -3.5, 3.5)
    area = U((B, P), 0.05, 0.08)
    return gm.contiguous(), v, u, area


def _plain_chunked(gm, v, u, area, fast, chunk=2048):
    """the plain version in lane chunks, bounding its [B, n, P] memory"""
    outs = []
    for i in range(0, gm.shape[0], chunk):
        a = area[i:i + chunk] if isinstance(area, torch.Tensor) else area
        outs.append(gmix_eval.eval_gmix_plain(
            gm[i:i + chunk], v[i:i + chunk], u[i:i + chunk], a, fast=fast
        ))
    return torch.cat(outs)


def compare(out, ref, what):
    """hold K2's output against its plain version's: rtol 1e-12 in
    float64; in float32 rtol 1e-5 with an atol of 1e-6 times the lane's
    max |model|. Returns the largest absolute and relative errors."""
    err = (out.double() - ref.double()).abs()
    if out.dtype == torch.float64:
        thr = 1e-12 * ref.abs()
    else:
        lane_max = ref.abs().amax(dim=-1, keepdim=True)
        thr = 1e-5 * ref.abs().double() + 1e-6 * lane_max.double()
    # a NaN error or threshold fails too
    if not bool(torch.isfinite(ref).all()) or not bool((err <= thr).all()):
        raise SmokeFailure("K2 disagrees with its plain version or is not finite: "
                           "%s, max err %.3e" % (what, float(err.max())))
    tiny = torch.finfo(ref.dtype).tiny
    return float(err.max()), float((err / ref.abs().double().clamp_min(tiny)).max())


def _at_offset(x, k=1):
    """a contiguous copy of x whose base lies k elements into its buffer"""
    buf = torch.empty(x.numel() + k, dtype=x.dtype, device=x.device)
    y = buf[k:].view(x.shape)
    y.copy_(x)
    return y


def _layouts(v, u, area):
    """K2's inputs as given, with a scalar area, as views at a
    one-element offset (a plain-load head before the first 16-byte
    boundary), and with only v at that offset (the inputs disagree on
    their alignment, so every tile takes plain loads)"""
    return (("tensor", v, u, area), ("scalar", v, u, 0.069),
            ("offset", _at_offset(v), _at_offset(u), _at_offset(area)),
            ("mixed", _at_offset(v), u, area))


def check_kernel(device):
    """K2 against its plain version over every listed case; returns the
    largest absolute error, the number of cases and the largest
    relative error per dtype"""
    gen = torch.Generator(device=device).manual_seed(2024)
    max_abs = 0.0
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    ncase = 0
    for dtype in (torch.float32, torch.float64):
        for n in (1, 3, 6, 18):
            for fast in (True, False):
                for B in (1, 3, NTYPES * 2048 + 3):
                    for P in (1, 361, 625, 1000, 2401):
                        gm, v, u, area = _random_case(gen, B, n, P, dtype, B >= 3)
                        for name, vl, ul, a in _layouts(v, u, area):
                            out = gmix_eval.eval_gmix(gm, vl, ul, a, fast=fast)
                            ref = _plain_chunked(gm, v, u, a if name == "scalar" else area,
                                                 fast)
                            err, rel = compare(
                                out, ref, "dtype=%s n=%d fast=%s B=%d P=%d layout=%s"
                                % (dtype, n, fast, B, P, name))
                            worst[dtype] = max(worst[dtype], rel)
                            max_abs = max(max_abs, err)
                            ncase += 1
    return max_abs, ncase, worst


def check_k2_batch_independence(device, B=3001, P=361):
    """K2 on a permuted third of the lanes, as given and at a one-element
    offset, gives the bits of the same lanes in the full batch: every
    path of the kernel (ring or plain loads, one lane a vector or
    several) runs the same arithmetic. Returns the lanes checked."""
    gen = torch.Generator(device=device).manual_seed(11)
    perm = torch.randperm(B, generator=torch.Generator().manual_seed(5))[: B // 3]
    perm = perm.to(device)
    for dtype in (torch.float32, torch.float64):
        for n in (1, 6, 18):
            for fast in (True, False):
                gm, v, u, area = _random_case(gen, B, n, P, dtype, True)
                full = gmix_eval.eval_gmix(gm, v, u, area, fast=fast)[perm]
                sub = [x[perm].contiguous() for x in (gm, v, u, area)]
                for what, args in (("permuted", sub),
                                   ("permuted at an offset", [sub[0]] + [
                                       _at_offset(x) for x in sub[1:]])):
                    if not torch.equal(gmix_eval.eval_gmix(*args, fast=fast), full):
                        raise SmokeFailure("K2 is not batch independent: %s, dtype=%s n=%d "
                                           "fast=%s" % (what, dtype, n, fast))
    return perm.numel()


def m_of(sr):
    return float(sr["shear"][0]) / SHEAR_TRUE - 1.0


def run_main(device, B, conf=CONF, measure="gaussmom"):
    """a moments main path: sims -> pipeline -> shear_response,
    homogeneous and heterogeneous, float32; three timed calls on the
    homogeneous sims (wall time, and the span between CUDA events at
    their start and end)"""
    fn = nt.make_metacal_pipeline_fn(conf, measure=measure, device=device)
    gen = torch.Generator(device=device).manual_seed(314)
    hom = nt.make_sim_batch(gen, B, torch.float32, device=device)
    res = fn(*hom)
    # timed calls after the first, which pays for FFT plans and library
    # setup; the median of three
    dt, dt_range, span = timed3(fn, *hom)
    het = nt.make_sim_batch_hetero(torch.Generator(device=device).manual_seed(271),
                                   B, torch.float32, device=device)
    het_res = fn(*het)
    _sync(device)
    out = dict(
        moments_gate(res, het_res, B),
        stamps_per_s=B / dt, sec=dt, sec_range=dt_range, span_ms=span, res=res,
        het_res=het_res,
    )
    return out, hom


def compare_results(card, cpu, what, int_keys=("flags", "numiter", "T_flags", "flux_flags",
                                               "rho4_flags")):
    """every field of two float64 result dicts of one type, card against
    CPU: the integer fields equal, the others to rtol 1e-8 and atol
    1e-10 with NaNs in the same places. Returns the largest share of
    that tolerance a difference takes"""
    worst = 0.0
    for k, b in cpu.items():
        a = card[k].cpu()
        if k in int_keys:
            if not torch.equal(a, b):
                raise SmokeFailure("%s: %s differ between card and CPU" % (what, k))
            continue
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise SmokeFailure("%s: NaNs of %s differ between card and CPU" % (what, k))
        a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        err = (a - b).abs()
        tol = 1e-10 + 1e-8 * b.abs()
        if bool((err > tol).any()):
            raise SmokeFailure("%s: %s differ between card and CPU: max %.3e"
                               % (what, k, float(err.max())))
        worst = max(worst, float((err / tol).max()))
    return worst


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main_path_shapes(device, B):
    """K2's two inputs on the main path: the gaussmom weight over the
    stacked 19x19 fit windows ([5 B, 361], area a tensor) and the sims'
    galaxies over 49x49 stamps ([B, 2401], n = 18, scalar area)"""
    dtype = torch.float32
    gen = torch.Generator(device=device).manual_seed(7)
    nb = NTYPES * B
    g = torch.arange(19, dtype=dtype, device=device)
    rr, cc = torch.meshgrid(g, g, indexing="ij")
    cen = 9.0 + torch.rand((nb, 2), generator=gen, device=device, dtype=dtype) - 0.5
    v = ((rr.reshape(-1)[None] - cen[:, :1]) * 0.263).contiguous()
    u = ((cc.reshape(-1)[None] - cen[:, 1:]) * 0.263).contiguous()
    wt = make_weight_gmix(1.2, dtype=dtype, device=device).expand(nb, 1, 6).contiguous()
    gaussmom = (wt, v, u, torch.full_like(v, 0.263**2))

    gal_pars = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.5, 100.0], dtype=dtype,
                            device=device).expand(B, 6)
    gal, _ = gcore.fill_exp(gal_pars)
    psf, _ = gcore.fill_turb(torch.tensor([0.0, 0.0, 0.025, -0.01, 0.27, 1.0],
                                          dtype=dtype, device=device))
    conv = gcore.gmix_convolve(gcore.gmix_get_sheared(gal, SHEAR_TRUE, 0.0),
                               psf.expand(B, 3, 6)).contiguous()
    g49 = torch.arange(49, dtype=dtype, device=device)
    rr, cc = torch.meshgrid(g49, g49, indexing="ij")
    cens = 24.0 + torch.rand((B, 2), generator=gen, device=device, dtype=dtype) - 0.5
    sv = ((rr.reshape(-1)[None] - cens[:, :1]) * 0.263).contiguous()
    su = ((cc.reshape(-1)[None] - cens[:, 1:]) * 0.263).contiguous()
    sims = (conv, sv, su, 0.263**2)
    return {"gaussmom n=1 [%dx361]" % nb: gaussmom,
            "sims n=18 [%dx2401]" % B: sims}


def bound(gm, v, area):
    """least time (ms) for K2's work: each input read once and the
    output written once at the memory rate, or its operations at the
    float peak, whichever is larger"""
    Bn, n, _ = gm.shape
    P = v.shape[1]
    esize = v.element_size()
    nbytes = esize * (gm.numel() + 3 * Bn * P)
    if isinstance(area, torch.Tensor):
        nbytes += esize * Bn * P
    ops = Bn * P * (OPS_PER_PIXEL_GAUSS * n + 1)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[v.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_k2(name, gm, v, u, area, fast):
    """K2 on these inputs: held against its plain version at phase 3's
    tolerances, then timed beside it and its bound"""
    err, rel = compare(gmix_eval.eval_gmix(gm, v, u, area, fast=fast),
                       _plain_chunked(gm, v, u, area, fast), name)
    ms = time_ms(lambda: gmix_eval.eval_gmix(gm, v, u, area, fast=fast), 20)
    plain_ms = time_ms(lambda: gmix_eval.eval_gmix_plain(gm, v, u, area, fast=fast), 3,
                       warmup=1)
    b_ms, by = bound(gm, v, area)
    return dict(kernel="K2", shape=name, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                max_abs_err=err, max_rel_err=rel, **k2_launch_attrs(gm, v, u, area, fast))


def k2_row_text(r):
    return ("    K2 %s: agrees (max abs err %.3e, rel %.3e); %.4f ms, plain %.4f ms, bound "
            "%.4f ms (%s); %s, grid %d, tile %d%s"
            % (r["shape"], r["max_abs_err"], r["max_rel_err"], r["ms"], r["plain_ms"],
               r["bound_ms"], r["bound_by"], attrs_text(r), r["grid"], r["tile"],
               "; %d launches a call" % r["launches_a_call"] if "launches_a_call" in r
               else ""))


def k2_launch_attrs(gm, v, u, area, fast):
    """K2's tile, grid, registers a thread, shared memory and blocks an
    SM for these inputs"""
    area_t = area if isinstance(area, torch.Tensor) else None
    plan, grid, _ = gmix_eval.plan_for(gm, v, u, area_t, fast)
    attrs = gmix_eval.kernel_attrs(v.device, v.dtype, fast, gm.shape[1], plan.smem_bytes)
    return dict(attrs, tile=plan.tile, lanes=plan.lanes, grid=grid)


def attrs_text(r):
    return ("%d registers, %d + %d bytes shared, %d blocks an SM%s"
            % (r["regs"], r["static_smem"], r["dynamic_smem"], r["blocks_per_sm"],
               ", %d bytes local" % r["local_bytes"] if "local_bytes" in r else ""))


# ----------------------------------------------------------------------
# K1 and the exp-LM path

def _k1_case(gen, B, n, P, dtype):
    """K1's inputs: the reparametrized random mixtures of _random_case
    (with an invalid gaussian in the last lane), a random chain and
    random weighted planes"""
    gm, v, u, _ = _random_case(gen, B, n, P, dtype, True)
    dev = gen.device
    rp = normal_eqs.gmix_reparam(gm).contiguous()
    chain = torch.randn((B, n, 6, 6), generator=gen, device=dev, dtype=dtype)
    ia = torch.rand((B, P), generator=gen, device=dev, dtype=dtype) * 100.0 + 50.0
    ve = torch.randn((B, P), generator=gen, device=dev, dtype=dtype) * 20.0
    return rp, chain, v, u, ia, ve


def _k1_plain_chunked(rp, chain, v, u, ia, ve, chunk=2048):
    """K1's plain version in lane chunks, bounding its [B, n, P] memory"""
    outs = [
        normal_eqs.gmix_normal_eqs_plain(*(x[i:i + chunk] for x in (rp, chain, v, u, ia, ve)))
        for i in range(0, rp.shape[0], chunk)
    ]
    return [torch.cat(parts) for parts in zip(*outs)]


def k1_scale(cost, JtJ):
    """the natural error scale of K1's signed sums, by Cauchy-Schwarz:
    sum_p |J_k ia fd| <= sqrt(JtJ_kk cost) for Jtr_k and sum_p
    |J_k J_m| ia^2 <= sqrt(JtJ_kk JtJ_mm) for JtJ_km"""
    d = torch.diagonal(JtJ, dim1=-2, dim2=-1).clamp_min(0).double()
    cost = cost.double()
    return torch.sqrt(d * cost[:, None]), torch.sqrt(d[:, :, None] * d[:, None, :])


def compare_k1(out, ref, what, tol32=(1e-5, 1e-5)):
    """hold K1's (cost, Jtr, JtJ) against its plain version's. float64:
    cost to rtol 1e-10, Jtr and JtJ to rtol 1e-8 with an atol of 1e-8
    times the largest |value|. float32: cost to rtol tol32[0]; Jtr and
    JtJ to rtol tol32[0] with an atol of tol32[1] times their
    Cauchy-Schwarz scale (k1_scale), which bounds the sum of the
    absolute terms that float32 rounds. Errors, thresholds and scales
    are taken in float64; a value, threshold or error that is not
    finite fails. Returns the largest absolute error and the largest
    error relative to |value| plus its scale."""
    max_abs, max_rel = 0.0, 0.0
    scales = (torch.zeros_like(ref[0], dtype=torch.float64),) + k1_scale(ref[0], ref[2])
    for i, (a, b) in enumerate(zip(out, ref)):
        a64, b64 = a.double(), b.double()
        err = (a64 - b64).abs()
        if a.dtype == torch.float64:
            thr = 1e-10 * b64.abs() if i == 0 else 1e-8 * b64.abs() + 1e-8 * b64.abs().max()
        elif i == 0:
            thr = tol32[0] * b64.abs()
        else:
            thr = tol32[0] * b64.abs() + tol32[1] * scales[i]
        bad = ~(torch.isfinite(thr) & (err <= thr))
        if bool(bad.any()):
            lane = int(bad.reshape(bad.shape[0], -1).any(-1).nonzero()[0, 0])
            raise SmokeFailure(
                "K1 disagrees with its plain version or is not finite: %s, output %d, "
                "max err %.3e; first bad lane %d: kernel %s plain %s" % (
                    what, i, float(err.max()), lane, a[lane].tolist(), b[lane].tolist()))
        max_abs = max(max_abs, float(err.max()))
        denom = (b64.abs() + scales[i]).clamp_min(torch.finfo(b.dtype).tiny)
        max_rel = max(max_rel, float((err / denom).max()))
    return max_abs, max_rel


def check_k1(device):
    """K1 against its plain version over every listed case"""
    gen = torch.Generator(device=device).manual_seed(2025)
    max_abs, ncase = 0.0, 0
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for dtype in (torch.float32, torch.float64):
        for n in (1, 6, 10):
            # phase 11 holds K1 at the main path's 5 B lanes
            for B in (1, 3, B_MAIN):
                for P in (361, 1000, 1089):
                    args = _k1_case(gen, B, n, P, dtype)
                    err, rel = compare_k1(
                        normal_eqs.gmix_normal_eqs(*args), _k1_plain_chunked(*args),
                        "dtype=%s n=%d B=%d P=%d" % (dtype, n, B, P))
                    max_abs = max(max_abs, err)
                    worst[dtype] = max(worst[dtype], rel)
                    ncase += 1
    return max_abs, ncase, worst


_EXP_LM_MEASURE = nt.batch._exp_lm_measure


def host_loop_route(**kw):
    """the exp-LM pipeline's host-loop route (run_lm_normal_batched with
    K1) in place of K3, for the phases that hold K1 and for the
    comparison with K3"""
    return mock.patch.object(nt.batch, "_exp_lm_measure", functools.partial(
        _EXP_LM_MEASURE, host_loop=True, **kw))


def reset_launches():
    gmix_eval.launches = normal_eqs.launches = lm_solve.launches = lm_solve.launches_mb = 0
    lm_solve.launches_refine = lm_solve.launches_varpro = 0


def read_launches():
    """the kernels' launches since reset_launches: K3, K1, K2, K3-mb, and
    K3's refine (k3r) and varpro (k3v) modes"""
    return dict(k3=lm_solve.launches, k1=normal_eqs.launches, k2=gmix_eval.launches,
                k3mb=lm_solve.launches_mb, k3r=lm_solve.launches_refine,
                k3v=lm_solve.launches_varpro)


def exp_lm_gate(res, het_res, B, npars=6):
    """bench.py's gate values of a hom and a het LM result of npars
    parameters (exp-LM's 6 by default), after the shape, finiteness and
    e1 == pars[:, 2] checks"""
    for r in (res, het_res):
        for t in nt.batch.GALSHEAR_TYPES:
            if not torch.equal(r[t]["e1"], r[t]["pars"][:, 2]):
                raise SmokeFailure("e1 is not pars[:, 2] for type %s" % t)
            if tuple(r[t]["pars"].shape) != (B, npars):
                raise SmokeFailure("bad pars shape %s" % (tuple(r[t]["pars"].shape),))
            ok = r[t]["flags"] == 0
            if not bool(torch.isfinite(r[t]["pars"][ok]).all()):
                raise SmokeFailure("non-finite pars for type %s" % t)
    sr, het_sr = nt.shear_response(res), nt.shear_response(het_res)
    return dict(m=m_of(sr), het_m=m_of(het_sr), R11=float(sr["R"][0, 0]),
                flagged=int((res["noshear"]["flags"] != 0).sum()),
                het_flagged=int((het_res["noshear"]["flags"] != 0).sum()))


def check_gate(g, B, what):
    if not (abs(g["m"]) < 1e-3 and abs(g["het_m"]) < 1e-3):
        raise SmokeFailure("%s m gate failed: m=%.3e hetero m=%.3e" % (what, g["m"], g["het_m"]))
    check_flagged(g, B, what)


def check_flagged(g, B, what):
    limit = max(8, int(0.005 * B))
    if g["flagged"] > limit or g["het_flagged"] > limit:
        raise SmokeFailure("too many flagged %s lanes: %d, %d > %d"
                           % (what, g["flagged"], g["het_flagged"], limit))


def check_selection(*results):
    """both selection estimators on exp-LM results with a cut that never
    binds (s2n > -1): R_sel 0 and shear equal to shear_response's to
    rtol 1e-10. Returns the largest relative difference"""
    worst = 0.0
    keep = lambda r: r["s2n"] > -1.0  # noqa: E731
    for res in results:
        plain = nt.shear_response(res)["shear"].double()
        sel = nt.shear_response_select(res, keep)
        if not bool((sel["R_sel"] == 0).all()):
            raise SmokeFailure("shear_response_select: R_sel is not 0 under a cut that never "
                               "binds: %s" % sel["R_sel"].tolist())
        for name, out in (("shear_response_select", sel["shear"]),
                          ("shear_response_select_consistent",
                           nt.shear_response_select_consistent(res, keep)["shear"])):
            err = (out.double() - plain).abs()
            if not bool((err <= 1e-10 * plain.abs()).all()):
                raise SmokeFailure("%s differs from shear_response: %s and %s"
                                   % (name, out.tolist(), plain.tolist()))
            worst = max(worst, float((err / plain.abs()).max()))
    return worst


def run_exp_lm(device, B):
    """the exp-LM main path (through K3): sims -> pipeline ->
    shear_response, homogeneous and heterogeneous, float32, with the
    kernels' launch counts of those two calls; then the guess of every
    lane (a run with maxfev = 1, which takes no step) for the frozen
    fraction"""
    fn = nt.make_metacal_pipeline_fn(LM_CONF, measure="exp-lm", device=device)
    hom = nt.make_sim_batch(torch.Generator(device=device).manual_seed(314), B,
                            torch.float32, device=device)
    het = nt.make_sim_batch_hetero(torch.Generator(device=device).manual_seed(271),
                                   B, torch.float32, device=device)
    _sync(device)
    reset_launches()
    res = fn(*hom)
    het_res = fn(*het)
    _sync(device)
    launches = read_launches()
    guess = nt.make_metacal_pipeline_fn(
        LM_CONF, measure="exp-lm", lm_conf=nt.LMConf(maxfev=1), device=device
    )(*hom)
    _sync(device)

    types = nt.batch.GALSHEAR_TYPES
    gate = exp_lm_gate(res, het_res, B)
    gate["select"] = check_selection(res, het_res)
    flags = torch.cat([res[t]["flags"] for t in types])
    nfev = torch.cat([res[t]["nfev"] for t in types]).double()
    het_nfev = torch.cat([het_res[t]["nfev"] for t in types]).double()
    frozen = (
        (flags == 0) & (nfev <= 2)
        & torch.all(torch.cat([res[t]["pars"] == guess[t]["pars"] for t in types]), dim=-1)
    )
    return dict(
        gate, launches=launches, frozen=float(frozen.double().mean()),
        nfev=[(float(x.mean()), float(torch.quantile(x, 0.5)), float(torch.quantile(x, 0.99)),
               int(x.max())) for x in (nfev, het_nfev)],
    ), hom, het, res


def host_loop_cpu_results(args):
    """the exp-LM pipeline's float64 results by the host-loop route on the
    CPU for the stamps args"""
    with host_loop_route():
        return nt.make_metacal_pipeline_fn(LM_CONF, measure="exp-lm", device="cpu")(
            *(a.cpu() for a in args))


def gaussmom_card_cpu(cpu_side):
    """phase 5: the gaussmom pipeline on the first N_CPU stamps in float64
    on the card and the CPU (cpu_side's job), every field compared"""
    t0 = time.perf_counter()
    (args, *_), cpu_res = cpu_side.get("5 gaussmom")
    card_res = nt.make_metacal_pipeline_fn(CONF, device="cuda")(*args)
    worst = max(compare_results(card_res[t], cpu_res[t], "gaussmom " + t)
                for t in nt.batch.GALSHEAR_TYPES)
    phase_line("5 cpu", t0, "256 stamps float64: flags equal, every field within rtol "
               "1e-8 + atol 1e-10 (at most %.3e of it)" % worst)


def compare_lm_card_cpu(cpu_side):
    """phase 9: per-lane float64 exp-LM run of the first N_CPU stamps by
    the host-loop route on the card and the CPU (cpu_side's job)"""
    t0 = time.perf_counter()
    (args,), cpu = cpu_side.get("9 host-loop")
    with host_loop_route():
        card = nt.make_metacal_pipeline_fn(LM_CONF, measure="exp-lm", device="cuda")(*args)
    worst, dnfev = 0.0, 0
    for t in nt.batch.GALSHEAR_TYPES:
        if not torch.equal(card[t]["flags"].cpu(), cpu[t]["flags"]):
            raise SmokeFailure("LM flags differ between card and CPU for %s" % t)
        d = int((card[t]["nfev"].cpu() - cpu[t]["nfev"]).abs().max())
        if d > 2:
            raise SmokeFailure("nfev differs by %d between card and CPU for %s" % (d, t))
        dnfev = max(dnfev, d)
        for k in ("e1", "e2", "T", "flux"):
            a, b = card[t][k].cpu(), cpu[t][k]
            err = (a - b).abs()
            if bool((err > 1e-7 + 1e-5 * b.abs()).any()):
                raise SmokeFailure("%s/%s differ between card and CPU: max %.3e"
                                   % (t, k, float(err.max())))
            worst = max(worst, float((err / b.abs().clamp_min(1e-300)).max()))
    phase_line("9 lm-cpu", t0, "256 stamps float64: flags equal, e1/e2/T/flux max "
               "rel diff %.3e, max nfev diff %d" % (worst, dnfev))


def check_compaction(hom, device):
    """the exp-LM pipeline's host-loop route at B_COMPACT stamps with the
    automatic compaction cascade and with none: the per-lane results
    must be bitwise equal"""
    args = [a[:B_COMPACT] for a in hom]
    fn = nt.make_metacal_pipeline_fn(LM_CONF, measure="exp-lm", device=device)
    with host_loop_route():
        cascade = fn(*args)
    with host_loop_route(compact_capacity=None):
        flat = fn(*args)
    for t in nt.batch.GALSHEAR_TYPES:
        for k in ("pars", "flags", "nfev", "ier", "cost"):
            if not torch.equal(cascade[t][k], flat[t][k]):
                raise SmokeFailure("compaction changed %s/%s" % (t, k))
    nfev = torch.cat([cascade[t]["nfev"] for t in nt.batch.GALSHEAR_TYPES])
    return (tlm.compaction_levels(nfev, nt.batch._auto_cascade(nfev.numel())),
            tlm.compaction_levels(nfev, None))


def capture_k_inputs(hom, device):
    """the inputs of the exp-LM host-loop route's first K1 call and of
    its K2 call with fast=True (get_loglike's s/n sums), from one
    pipeline call"""
    seen = {}
    k1, k2 = normal_eqs.gmix_normal_eqs, gmix_eval.eval_gmix

    def k1_spy(*a):
        seen.setdefault("k1", a)
        return k1(*a)

    def k2_spy(gm, v, u, area=1.0, fast=True):
        if fast:
            seen.setdefault("k2", (gm, v, u, area))
        return k2(gm, v, u, area, fast=fast)

    with mock.patch.object(normal_eqs, "gmix_normal_eqs", k1_spy), \
            mock.patch.object(gmix_eval, "eval_gmix", k2_spy), host_loop_route():
        nt.make_metacal_pipeline_fn(LM_CONF, measure="exp-lm", device=device)(*hom)
    return seen["k1"], seen["k2"]


def pixel_ops(rp, v, u, counts):
    """operations of one pixel pass on these inputs, per lane [B], with
    counts = (per pair, per pair inside the window, per pair in its
    apodized band, per pixel): the pairs inside the window and in the
    band counted from chi2"""
    ops_pair, ops_inwin, ops_hot, ops_pixel = counts
    Bn, n, _ = rp.shape
    P = v.shape[1]
    inwin, hot = [], []
    for i in range(0, Bn, 4096):
        q = rp[i:i + 4096, :, :, None]
        dv = v[i:i + 4096, None, :] - q[:, :, 1]
        du = u[i:i + 4096, None, :] - q[:, :, 2]
        chi2 = (q[:, :, 3] * dv + q[:, :, 4] * du) * dv + (q[:, :, 4] * dv + q[:, :, 5] * du) * du
        win = (chi2 >= 0) & (chi2 < 25.0)
        inwin.append(win.sum(dim=(1, 2)))
        hot.append((win & (chi2 > 20.0)).sum(dim=(1, 2)))
    return (ops_pair * n * P + ops_inwin * torch.cat(inwin)
            + ops_hot * torch.cat(hot) + ops_pixel * P)


def least_ms(nbytes, ops, dtype):
    """the larger of nbytes at the memory rate and ops at the float
    peak, in ms, and which of the two it is"""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_bound(rp, chain, v, u, ia, ve):
    """least time (ms) for K1's work on these inputs: each input read
    once and the outputs written once at the memory rate, or the
    operations this data needs (K1_OPS) at the float peak, whichever is
    larger"""
    Bn, n, _ = rp.shape
    P = v.shape[1]
    nbytes = v.element_size() * (rp.numel() + chain.numel() + 4 * Bn * P + Bn * (1 + 6 + 36))
    return least_ms(nbytes, int(pixel_ops(rp, v, u, K1_OPS).sum()), v.dtype)


def time_lm_kernels(hom, device):
    """K1 and K2 at the exp-LM path's shapes: held against their plain
    versions on the pipeline's own inputs, then timed beside their
    bounds"""
    k1_args, (gm, v, u, area) = capture_k_inputs(hom, device)
    rows = []
    err, rel = compare_k1(normal_eqs.gmix_normal_eqs(*k1_args), _k1_plain_chunked(*k1_args),
                          "main-path shape", tol32=(1e-3, 1e-4))
    ms = time_ms(lambda: normal_eqs.gmix_normal_eqs(*k1_args), 20)
    plain_ms = time_ms(lambda: normal_eqs.gmix_normal_eqs_plain(*k1_args), 3, warmup=1)
    b_ms, by = k1_bound(*k1_args)
    rows.append(dict(kernel="K1", shape="n=%d [%dx%d]" % (k1_args[0].shape[1], *k1_args[2].shape),
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                     max_abs_err=err, max_rel_err=rel))
    rows.append(time_k2("exp-lm get_loglike n=%d fast [%dx%d]" % (gm.shape[1], *v.shape),
                        gm, v, u, area, True))
    return rows


# ----------------------------------------------------------------------
# K3

def capture_k3_inputs(args, device, conf=LM_CONF, measure="exp-lm", **kw):
    """the inputs of an LM path's K3 call but the LMConf and the model,
    from one pipeline call of the measure under conf on args (kw: more
    pipeline options), and the pipeline's results"""
    seen = {}
    k3 = lm_solve.lm_solve

    def spy(*a, **kw):
        seen["k3"] = a[:8]  # guess, lo, hi, psf, v, u, ia, ve
        return k3(*a, **kw)

    with mock.patch.object(lm_solve, "lm_solve", spy):
        res = nt.make_metacal_pipeline_fn(conf, measure=measure, device=device, **kw)(*args)
    return seen["k3"], res


def per_lane_diff(a, b, what, rtol=1e-5, atol=1e-7, dnfev=2, keys=("e1", "e2", "T", "flux")):
    """hold two exp-LM results (dicts of [N] columns) per lane: flags
    equal, the keys (e1/e2/T/flux) to rtol and atol, nfev within dnfev.
    Returns the largest absolute and relative differences and the nfev
    difference"""
    if not torch.equal(a["flags"], b["flags"]):
        raise SmokeFailure("%s: flags differ on %d lanes"
                           % (what, int((a["flags"] != b["flags"]).sum())))
    d = int((a["nfev"] - b["nfev"]).abs().max())
    if d > dnfev:
        raise SmokeFailure("%s: nfev differs by %d" % (what, d))
    max_abs = max_rel = 0.0
    for k in keys:
        x, y = a[k].double(), b[k].double()
        err = (x - y).abs()
        if not bool(torch.isfinite(x).all()) or bool((err > atol + rtol * y.abs()).any()):
            raise SmokeFailure("%s: %s differs, max %.3e" % (what, k, float(err.max())))
        max_abs = max(max_abs, float(err.max()))
        max_rel = max(max_rel, float((err / y.abs().clamp_min(1e-300)).max()))
    return max_abs, max_rel, d


def solve_cols(out):
    """e1, e2, T, flux (the last column: bdf and bd have their extra
    shape columns before it), their pars_err, flags and nfev of an LM
    result"""
    idx = [2, 3, 4, out["pars"].shape[1] - 1]
    cols = dict(zip(("e1", "e2", "T", "flux"), out["pars"][:, idx].unbind(-1)))
    return dict(cols, err=out["pars_err"][:, idx], flags=out["flags"], nfev=out["nfev"])


def solve_columns(state, args, conf):
    """solve_cols of the epilogue of a K3 state on K3's inputs args =
    (guess, lo, hi, psf, v, u, ia, ve)"""
    nres = torch.sum(args[6] > 0, dim=-1)
    return solve_cols(tlm._normal_epilogue(state, args[1], args[2], conf, nres))


def f32_split(a, b, keys=("e1", "e2", "T", "flux")):
    """the share of lanes whose keys (e1/e2/T/flux, the columns of err)
    differ by more than rtol 1e-4, and the largest difference over lanes
    unflagged in both in units of b's pars_err"""
    split = torch.stack([(a[k] - b[k]).abs() > 1e-4 * b[k].abs() for k in keys]).any(0)
    ok = (a["flags"] == 0) & (b["flags"] == 0)
    d = torch.stack([(a[k].double() - b[k].double()).abs() for k in keys], -1)
    sig = b["err"].double()
    return float(split.double().mean()), float((d / sig)[ok].max())


def check_batch_independence(args, conf, solve=lm_solve.lm_solve, model="exp", prior=None):
    """K3 (or K3-mb) of the model (with the prior's rows) on a permuted
    third of the lanes gives the bits of the same lanes in the full
    batch"""
    full = solve(*args, conf, model, prior)
    n = args[0].shape[0]
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(5))[: n // 3]
    perm = perm.to(args[0].device)
    sub = solve(*(a if a.dim() == 1 else a[perm].contiguous() for a in args), conf, model,
                prior)
    for k, x in sub.items():
        if not torch.equal(x, full[k][perm]):
            raise SmokeFailure("%s is not batch independent: %s differs" % (solve.__name__, k))
    return n // 3


def bounded_case(device, n=B_BOUNDED, dims=(19, 19), scale=0.263):
    """K3's inputs for n synthetic exp stamps in float64 with bounds that
    pin dims: g1 in [-0.05, 0.05] with |g1| up to 0.3 in the truths,
    the centre in [-1, 1], T >= 0"""
    dtype = torch.float64
    gen = torch.Generator(device=device).manual_seed(99)

    def U(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device, dtype=dtype) * (hi - lo) + lo

    truth = torch.stack([U(n, -0.1, 0.1), U(n, -0.1, 0.1), U(n, -0.3, 0.3),
                         U(n, -0.3, 0.3), U(n, 0.1, 0.8), U(n, 20.0, 150.0)], -1)
    psf = torch.stack([U(n, 0.05, 0.06), U(n, -0.003, 0.003), U(n, 0.05, 0.06)], -1)
    g = torch.arange(dims[0], dtype=dtype, device=device)
    rr, cc = torch.meshgrid(g, g, indexing="ij")
    cen = (dims[0] - 1) / 2.0
    v = ((rr.reshape(-1) - cen) * scale).expand(n, -1).contiguous()
    u = ((cc.reshape(-1) - cen) * scale).expand(n, -1).contiguous()
    gal, _ = gcore.fill_exp(truth)
    model = gcore.eval_gmix(gcore.gmix_convolve(gal, nt.batch._psf_gmix(psf)), v, u,
                            scale**2, fast=False)
    noise = 1e-3
    val = model + noise * torch.randn(model.shape, generator=gen, device=device, dtype=dtype)
    ierr = torch.full_like(val, 1.0 / noise)
    guess = truth + torch.randn(truth.shape, generator=gen, device=device, dtype=dtype) * \
        torch.tensor([0.05, 0.05, 0.05, 0.05, 0.05, 5.0], dtype=dtype, device=device)
    inf = float("inf")
    lo = torch.tensor([-1.0, -1.0, -0.05, -inf, 0.0, -inf], dtype=dtype, device=device)
    hi = torch.tensor([1.0, 1.0, 0.05, inf, inf, inf], dtype=dtype, device=device)
    area = torch.full_like(val, scale**2)
    return (guess.contiguous(), lo, hi, psf.contiguous(), v, u,
            (ierr * area).contiguous(), (val * ierr).contiguous())


def check_k3(device, hom):
    """phase 12: K3 in float64 against the host-loop route, its plain
    version and, with bounds, run_lm_normal_batched"""
    out = {}
    fn = nt.make_metacal_pipeline_fn(LM_CONF, measure="exp-lm", device=device)
    args = [a[:B_COMPACT].double() for a in hom]
    k3_args, k3 = capture_k3_inputs(args, device)
    with host_loop_route():
        host = fn(*args)
    worst = [per_lane_diff(k3[t], host[t], "K3 and host-loop routes, %s" % t)
             for t in nt.batch.GALSHEAR_TYPES]
    out["routes64"] = (max(w[1] for w in worst), max(w[2] for w in worst))
    conf = nt.LMConf()
    plain = lm_solve.lm_solve_plain(*k3_args, conf)
    state = lm_solve.lm_solve(*k3_args, conf)
    out["plain64"] = per_lane_diff(solve_columns(state, k3_args, conf),
                                   solve_columns(plain, k3_args, conf), "K3 and its plain version")

    bargs = bounded_case(device)
    state = lm_solve.lm_solve(*bargs, conf)
    if not bool(state["pinned"].any()):
        raise SmokeFailure("the bounded case pinned no dim")
    planes, psf_gmix = bargs[4:], nt.batch._psf_gmix(bargs[3])
    ref = tlm.run_lm_normal_batched(nt.batch._normal_fn, (planes, psf_gmix), bargs[0],
                                    bargs[1], bargs[2], conf,
                                    nres=torch.sum(bargs[6] > 0, dim=-1))
    ref_cols = dict(zip(("e1", "e2", "T", "flux"), ref["pars"][:, 2:].unbind(-1)),
                    flags=ref["flags"], nfev=ref["nfev"])
    out["bounded"] = per_lane_diff(solve_columns(state, bargs, conf), ref_cols,
                                   "K3 and run_lm_normal_batched with bounds")
    out["pinned"] = int(state["pinned"].any(-1).sum())

    # full 49x49 stamps (P = 2401, the planes past shared memory): the
    # reference's README input, 13 stamps of sims seed 1 cut to 64 lanes,
    # in float64; then 2048 stamps of the main path's sims in float32,
    # checked and timed
    full = [a.to(device) for a in nt.make_sim_batch(torch.Generator().manual_seed(1), 13,
                                                      torch.float64, device="cpu")]
    fargs, _ = capture_k3_inputs(full, device, conf=FULL_CONF)
    fargs = tuple(a if a.dim() == 1 else a[:64].contiguous() for a in fargs)
    out["full64"] = per_lane_diff(
        solve_columns(lm_solve.lm_solve(*fargs, conf), fargs, conf),
        solve_columns(lm_solve.lm_solve_plain(*fargs, conf), fargs, conf),
        "K3 and its plain version at P = 2401")
    args32, _ = capture_k3_inputs([a[:B_COMPACT] for a in hom], device, conf=FULL_CONF)
    out["full32"] = k3_timed_row(args32, conf)
    return out


def timed_call(fn, *args):
    """one call's result, its wall time (s) and the span (ms) between
    CUDA events recorded on the current stream at its start and end"""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn(*args)
    end.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end)


def model_rp(pars, psf_gmix, model):
    """the reparametrized gaussians of the model at pars, whose count
    (6, 1 or 10) the operation counts take"""
    rp = nt.batch._exp_reparam(pars, psf_gmix, model)[0]
    if rp.shape[1] != NGAUSS[model]:
        raise SmokeFailure("the %s model gave %d gaussians, not %d"
                           % (model, rp.shape[1], NGAUSS[model]))
    return rp


def k3_bound(args, state, model="exp", prior=None):
    """least time (ms) for K3's work on these inputs: the planes, guess,
    bounds, psf and the prior's table read once and the state written
    once at the memory rate, or K3's operations per evaluation (k3_ops
    over the model's gaussians and parameters, the window counted at the
    lane's guess, and prior_ops) times each lane's nfev at the float
    peak, whichever is larger"""
    guess, lo, hi, psf, v, u, ia, ve = args
    rp = model_rp(guess, nt.batch._psf_gmix(psf), model)
    npars = guess.shape[1]
    ops = int(((pixel_ops(rp, v, u, k3_ops(npars)) + prior_ops(prior, npars))
               * state["nfev"].long()).sum())
    N, P = v.shape
    esize = v.element_size()
    nbytes = (esize * (4 * N * P + guess.numel() + 12 + psf.numel()) + prior_bytes(prior)
              + sum(x.numel() * x.element_size() for x in state.values()))
    return least_ms(nbytes, ops, v.dtype)


def lanes(args, n):
    """the first n lanes of a kernel's inputs (all for n None)"""
    return args if n is None else tuple(x if x.dim() == 1 else x[:n] for x in args)


def k3_timed_row(args, conf, model="exp", prior=None, plain_lanes=None):
    """K3 of the model (with the prior's rows) on its captured float32
    inputs against its plain version (flags equal on every lane, and on
    every lane both leave unflagged e1/e2/T/flux within half the lane's
    pars_err; on the first plain_lanes lanes where given, the plain
    version's time there), bitwise batch independent, and timed beside
    its bound and its plain version"""
    state = lm_solve.lm_solve(*args, conf, model, prior)
    pa = lanes(args, plain_lanes)
    plain, _, plain_ms = timed_call(lm_solve.lm_solve_plain, *pa, conf, model, prior)
    a = {k: v[:len(pa[0])] for k, v in solve_columns(state, args, conf).items()}
    b = solve_columns(plain, pa, conf)
    n = a["flags"].numel()
    flags_diff = int((a["flags"] != b["flags"]).sum())
    split, in_err = f32_split(a, b)
    finite = all(bool(torch.isfinite(a[k]).all()) for k in ("e1", "e2", "T", "flux"))
    if not finite or flags_diff or not in_err <= 0.5:
        raise SmokeFailure("K3 (%s) disagrees with its plain version on %s: flags differ "
                           "on %d lanes, largest difference %.3e pars_err, finite %s"
                           % (model, tuple(args[4].shape), flags_diff, in_err, finite))
    max_abs = max(float((a[k].double() - b[k].double()).abs().max())
                  for k in ("e1", "e2", "T", "flux"))
    indep = check_batch_independence(args, conf, model=model, prior=prior)
    ms = time_ms(lambda: lm_solve.lm_solve(*args, conf, model, prior), K3_TIMED)
    b_ms, by = k3_bound(args, state, model, prior)
    return dict(shape="%s NG=%d [%dx%d]%s" % (model, NGAUSS[model], *args[4].shape,
                                             prior_text(prior)), ms=ms,
                plain_ms=plain_ms, plain_lanes=len(pa[0]), bound_ms=b_ms, bound_by=by,
                max_abs_err=max_abs, split=split, max_in_err=in_err, indep=indep, lanes=n,
                nfev_sum=int(state["nfev"].sum()))


def time_k3(device, hom, het, res_k3):
    """phase 13: K3 at its main-path shape against its plain version and
    timed; the exp-LM call by both routes, interleaved, the host-loop
    route's gate from its first timed call and a het call"""
    args, _ = capture_k3_inputs(hom, device)
    conf = nt.LMConf()
    row = k3_timed_row(args, conf)

    fn = nt.make_metacal_pipeline_fn(LM_CONF, measure="exp-lm", device=device)

    def host_fn(*a):
        with host_loop_route():
            return fn(*a)

    routes = {"k3": fn, "host": host_fn}
    walls = {r: [] for r in routes}
    spans = {r: [] for r in routes}
    res_h = None
    for i in range(N_TIMED):
        for r in (("k3", "host") if i % 2 == 0 else ("host", "k3")):
            reset_launches()
            res, wall, span = timed_call(routes[r], *hom)
            if r == "host" and res_h is None:
                res_h, hl = res, read_launches()
            walls[r].append(wall)
            spans[r].append(span)
    reset_launches()
    het_h = host_fn(*het)
    _sync(device)
    host = dict(gate=exp_lm_gate(res_h, het_h, B_MAIN),
                launches={k: x + hl[k] for k, x in read_launches().items()})
    splits = [f32_split(solve_cols(res_k3[t]), solve_cols(res_h[t]))
              for t in nt.batch.GALSHEAR_TYPES]
    host["split32"] = (sum(x[0] for x in splits) / NTYPES, max(x[1] for x in splits))
    calls = {}
    for r, f in routes.items():
        w = sorted(walls[r])
        calls[r] = dict(stamps_per_s=B_MAIN / w[N_TIMED // 2], sec=w[N_TIMED // 2],
                        sec_range=(w[0], w[-1]), span_ms=sorted(spans[r])[N_TIMED // 2])
    return row, calls, host


# ----------------------------------------------------------------------
# admom and the psf modes

def numiter_stats(*numiter):
    """mean, p50 and max of the lanes' numiter over every tensor given;
    the max is the host loop's iterations (a lane stays active from the
    first iteration until it is done)"""
    x = torch.cat(numiter).double()
    return float(x.mean()), float(torch.quantile(x, 0.5)), int(x.max())


def pipeline_numiter(res, types=nt.batch.GALSHEAR_TYPES):
    return numiter_stats(*(res[t]["numiter"] for t in types))


def capture_k2_inputs(fn, *args, fast=True):
    """the inputs of the first K2 launch in mode fast in one call
    fn(*args), and how many launches of that call in that mode had
    their shape (gaussians and [B, P])"""
    first, shapes = [], []
    k2 = gmix_eval.eval_gmix

    def spy(gm, v, u, area=1.0, fast=True):
        if fast == mode:
            if not first:
                first.append((gm, v, u, area))
            shapes.append((gm.shape[1], *v.shape))
        return k2(gm, v, u, area, fast=fast)

    mode = fast
    with mock.patch.object(gmix_eval, "eval_gmix", spy):
        fn(*args)
    gm, v = first[0][:2]
    return first[0], shapes.count((gm.shape[1], *v.shape))


def time_k2_captured(name, fn, *args, pixels=None):
    """time_k2 on the first fast K2 launch of fn(*args), with its
    launches a call at that shape; fails if that launch does not have
    the pixels a lane expected"""
    inputs, launches = capture_k2_inputs(fn, *args)
    gm, v = inputs[:2]
    if pixels is not None and v.shape[1] != pixels:
        raise SmokeFailure("%s: the first fast K2 launch has %d pixels a lane, not %d"
                           % (name, v.shape[1], pixels))
    row = time_k2("%s n=%d fast [%dx%d]" % (name, gm.shape[1], *v.shape), *inputs, fast=True)
    return dict(row, launches_a_call=launches)


def run_admom_batch(device, hom):
    """bench.py's standalone admom shape: admom_batch on the full 49x49
    stamps with a round T = 0.6 guess, three timed calls; and K2 on the
    inputs of its first weight"""
    B = hom[0].shape[0]
    pixels = nt.batch.make_pixels_batch(hom[0], hom[1], hom[2], CONF)
    wt0 = nt.batch.round_wt0(B, 0.6, torch.float32, device)
    area = torch.full((B,), nt.sims.SCALE**2, dtype=torch.float32, device=device)
    conf = nt.AdmomConf()
    fn = functools.partial(nt.admom_batch, conf=conf, device=device)
    res = fn(pixels, wt0, area)
    sec, sec_range, _ = timed3(fn, pixels, wt0, area)
    row = time_k2_captured("admom_batch", fn, pixels, wt0, area)
    return dict(flagged=int((res["flags"] != 0).sum()), numiter=numiter_stats(res["numiter"]),
                stamps_per_s=B / sec, sec_range=sec_range), row


def check_k3_dilate(k3_args):
    """K3 against its plain version on the dilate exp-LM solve's inputs
    (an elliptical psf per lane), phase 13's float32 criterion: flags
    equal, e1/e2/T/flux within half the lane's pars_err"""
    conf = nt.LMConf()
    a = solve_columns(lm_solve.lm_solve(*k3_args, conf), k3_args, conf)
    b = solve_columns(lm_solve.lm_solve_plain(*k3_args, conf), k3_args, conf)
    flags_diff = int((a["flags"] != b["flags"]).sum())
    split, in_err = f32_split(a, b)
    finite = all(bool(torch.isfinite(a[k]).all()) for k in ("e1", "e2", "T", "flux"))
    if not finite or flags_diff or not in_err <= 0.5:
        raise SmokeFailure("K3 disagrees with its plain version on the dilate exp-LM inputs: "
                           "flags differ on %d lanes, largest difference %.3e pars_err, "
                           "finite %s" % (flags_diff, in_err, finite))
    psf = k3_args[3]
    return dict(lanes=a["flags"].numel(), split=split, max_in_err=in_err,
                max_abs_irc=float(psf[:, 1].abs().max()))


TYPES9 = nt.batch.GALSHEAR_TYPES + nt.batch.PSFSHEAR_TYPES
# phase 17's runs: (measure, configuration)
PSF_MODE_RUNS = [("gaussmom", CONF._replace(psf_mode="fitgauss")),
                 ("gaussmom", CONF._replace(psf_mode="azgauss")),
                 ("gaussmom", CONF._replace(psf_mode="dilate", types=TYPES9)),
                 ("admom", ADMOM_CONF._replace(psf_mode="dilate", types=TYPES9)),
                 ("exp-lm", LM_CONF._replace(psf_mode="dilate", types=TYPES9))]


def psf_mode_runs(device, hom, het):
    """the psf modes at B_MAIN in float32: gaussmom under fitgauss,
    azgauss and dilate (all 9 types), admom and exp-LM under dilate,
    on the homogeneous and heterogeneous sims, gated on flagged lanes;
    fitgauss also on |m|, dilate on psf_shear_response; K3 against its
    plain version on the dilate exp-LM solve's own inputs; K2 on the
    psf-stamp admom weights of fitgauss and of the dilate exp-LM"""
    types9 = TYPES9
    runs = PSF_MODE_RUNS
    out, k2_rows = [], []
    k3 = None
    psf_pixels = CONF.psf_dims[0] * CONF.psf_dims[1]
    for measure, conf in runs:
        fn = nt.make_metacal_pipeline_fn(conf, measure=measure, device=device)
        _sync(device)
        reset_launches()
        if measure == "exp-lm":
            k3_args, res = capture_k3_inputs(hom, device, conf)
        else:
            res = fn(*hom)
        het_res = fn(*het)
        _sync(device)
        row = dict(measure=measure, mode=conf.psf_mode, launches=read_launches(),
                   **exp_lm_gate(res, het_res, B_MAIN) if measure == "exp-lm"
                   else moments_gate(res, het_res, B_MAIN))
        check_flagged(row, B_MAIN, "%s %s" % (measure, conf.psf_mode))
        if conf.psf_mode == "fitgauss" and not abs(row["m"]) < 1.5e-3:
            raise SmokeFailure("fitgauss m gate failed: m=%.3e" % row["m"])
        if conf.psf_mode == "dilate":
            rp = nt.psf_shear_response(res)
            row["R_psf"] = rp.tolist()
            if not bool(torch.isfinite(rp).all()):
                raise SmokeFailure("%s dilate psf_shear_response not finite" % measure)
            d, off = rp.diagonal(), torch.stack([rp[0, 1], rp[1, 0]])
            # the reference's bounds for a psf-blind measure
            # (tests/test_batch_pipeline.py:474-480)
            if measure == "gaussmom" and not (bool((d > 0.02).all())
                                              and bool((off.abs() < 0.5 * d).all())):
                raise SmokeFailure("gaussmom dilate psf_shear_response out of bounds: %s"
                                   % rp.tolist())
        if measure == "admom":
            row["numiter"] = pipeline_numiter(res, types9)
        if measure == "exp-lm":
            k3 = check_k3_dilate(k3_args)
            if row["launches"]["k3"] <= 0:
                raise SmokeFailure("the dilate exp-LM path did not launch K3")
        if row["launches"]["k2"] <= 0:
            raise SmokeFailure("%s under %s did not launch K2" % (measure, conf.psf_mode))
        if (measure, conf.psf_mode) in (("gaussmom", "fitgauss"), ("exp-lm", "dilate")):
            # the first fast K2 launch of these calls is the admom weight
            # over the psf stamps (fitgauss) or over the nine types'
            # rendered targets (dilate)
            k2_rows.append(time_k2_captured("%s %s psf-stamp admom" % (measure, conf.psf_mode),
                                            fn, *hom, pixels=psf_pixels))
        out.append(row)
    return out, runs, k3, k2_rows


def moments_gate(res, het_res, B):
    """m, hetero m and the flagged noshear lanes of a moments pipeline's
    hom and het results, after the shape and finiteness checks"""
    for r in (res, het_res):
        for t in nt.batch.GALSHEAR_TYPES:
            pars = r[t]["pars"]
            ok = r[t]["flags"] == 0
            if tuple(pars.shape) != (B, 6) or not bool(torch.isfinite(pars[ok]).all()):
                raise SmokeFailure("bad pars for type %s: shape %s or not finite"
                                   % (t, tuple(pars.shape)))
    sr = nt.shear_response(res)
    return dict(m=m_of(sr), het_m=m_of(nt.shear_response(het_res)), R11=float(sr["R"][0, 0]),
                flagged=int((res["noshear"]["flags"] != 0).sum()),
                het_flagged=int((het_res["noshear"]["flags"] != 0).sum()))


def pipeline_cpu_results(args, conf, measure):
    """the pipeline's float64 results of the measure under conf on the
    CPU for the stamps args"""
    return nt.make_metacal_pipeline_fn(conf, measure=measure, device="cpu")(
        *(a.cpu() for a in args))


def psf_modes_card_cpu(cpu_side, runs):
    """the first N_CPU stamps of each psf-mode run in float64 on the card
    and the CPU (cpu_side's jobs): psf_sigma and every result field to
    rtol 1e-8 (the moments measures); the exp-LM card route (K3) against
    the CPU's plain version by phase 12's criterion (flags equal,
    e1/e2/T/flux to rtol 1e-5 and atol 1e-7, nfev within 2). Returns the
    largest share of the tolerance of the rtol 1e-8 comparisons"""
    worst = 0.0
    for measure, conf in runs:
        (args, _, _), cpu = cpu_side.get("17 %s %s" % (measure, conf.psf_mode))
        card = nt.make_metacal_pipeline_fn(conf, measure=measure, device="cuda")(*args)
        what = "%s %s" % (measure, conf.psf_mode)
        worst = max(worst, compare_results({"s": card["psf_sigma"]},
                                           {"s": cpu["psf_sigma"]}, what + " psf_sigma"))
        for t in conf.types:
            if measure == "exp-lm":
                per_lane_diff({k: card[t][k].cpu() for k in cpu[t]}, cpu[t], what + " " + t)
            else:
                worst = max(worst, compare_results(card[t], cpu[t], "%s %s" % (what, t)))
    return worst


def admom_phases(device, t_all, cpu_side):
    """phases 14-17: the admom main path and its checks, admom_batch at
    bench.py's standalone shape, and the psf modes. Returns K2's
    launches on the admom path, K2's rows at admom's shapes (the psf
    stamps' included) and the psf-mode runs"""
    t0 = time.perf_counter()
    _sync(device)
    reset_launches()
    ap, hom = run_main(device, B_MAIN, ADMOM_CONF, "admom")
    _sync(device)
    admom_launches = read_launches()["k2"]
    it_hom, it_het = pipeline_numiter(ap["res"]), pipeline_numiter(ap["het_res"])
    fn_admom = nt.make_metacal_pipeline_fn(ADMOM_CONF, measure="admom", device=device)
    phase_line(
        "14 admom", t0,
        "B=%d m=%.3e hetero_m=%.3e R11=%.4f flagged=%d hetero_flagged=%d k2_launches=%d "
        "stamps/s=%.1f (median %.4f s/call of 3, range %.4f-%.4f); numiter (mean, p50, max): "
        "hom (%.3f, %g, %d) het (%.3f, %g, %d); host-loop iterations a call: hom %d het %d; "
        "event span %.3f ms"
        % (B_MAIN, ap["m"], ap["het_m"], ap["R11"], ap["flagged"], ap["het_flagged"],
           admom_launches, ap["stamps_per_s"], ap["sec"], *ap["sec_range"], *it_hom, *it_het,
           it_hom[2], it_het[2], ap["span_ms"]))
    check_gate(ap, B_MAIN, "admom")
    if admom_launches <= 0:
        raise SmokeFailure("the admom path did not launch K2")
    # one call: two K2 launches an iteration and one for the covariance
    reset_launches()
    fn_admom(*hom)
    _sync(device)
    if read_launches()["k2"] != 2 * it_hom[2] + 1:
        raise SmokeFailure("an admom call launched K2 %d times, not twice an iteration and "
                           "once more" % read_launches()["k2"])

    def admom_card_cpu():
        t0 = time.perf_counter()
        (args, *_), cpu = cpu_side.get("15 admom")
        card = fn_admom(*args)
        admom_worst = max(compare_results(card[t], cpu[t], "admom " + t)
                          for t in nt.batch.GALSHEAR_TYPES)
        phase_line("15 admom-cpu", t0, "256 stamps float64: flags and numiter equal, every "
                   "field within rtol 1e-8 + atol 1e-10 (at most %.3e of it)" % admom_worst)

    cpu_side.defer(admom_card_cpu)

    t0 = time.perf_counter()
    ab, ab_row = run_admom_batch(device, hom)
    admom_rows = [time_k2_captured("admom pipeline", fn_admom, *hom), ab_row]
    print("; ".join(k2_row_text(r) for r in admom_rows), flush=True)
    phase_line("16 admom-batch", t0, "B=%d 49x49: flagged=%d numiter (mean, p50, max) "
               "(%.3f, %g, %d) stamps/s=%.1f (median of 3, range %.4f-%.4f s)"
               % (B_MAIN, ab["flagged"], *ab["numiter"], ab["stamps_per_s"],
                  *ab["sec_range"]))

    t0 = time.perf_counter()
    het = nt.make_sim_batch_hetero(torch.Generator(device=device).manual_seed(271),
                                   B_MAIN, torch.float32, device=device)
    modes, runs, k3d, psf_rows = psf_mode_runs(device, hom, het)
    del het
    for r in psf_rows:
        print(k2_row_text(r), flush=True)
    print("    " + "; ".join(
        "%s %s: m=%.3e hetero_m=%.3e flagged=%d hetero_flagged=%d launches k3=%d k2=%d%s%s"
        % (r["measure"], r["mode"], r["m"], r["het_m"], r["flagged"], r["het_flagged"],
           r["launches"]["k3"], r["launches"]["k2"],
           " R_psf=[[%.4f, %.4f], [%.4f, %.4f]]" % sum(map(tuple, r["R_psf"]), ())
           if "R_psf" in r else "",
           " numiter (%.3f, %g, %d)" % r["numiter"] if "numiter" in r else "")
        for r in modes), flush=True)
    print("    K3 on the dilate exp-LM inputs (%d lanes, |psf irc| up to %.3e) against its "
          "plain version: flags equal, %.4f outside rtol 1e-4, largest difference %.3e "
          "pars_err" % (k3d["lanes"], k3d["max_abs_irc"], k3d["split"], k3d["max_in_err"]),
          flush=True)
    del hom

    def modes_card_cpu():
        t1 = time.perf_counter()
        modes_worst = psf_modes_card_cpu(cpu_side, runs)
        phase_line("17 psf-modes", t1, "256 stamps float64 card against CPU: psf_sigma and "
                   "the moments results within rtol 1e-8 + atol 1e-10 (at most %.3e of it), "
                   "exp-LM within phase 12's tolerances; the card side %.1f s; total %.1f s"
                   % (modes_worst, t_card, time.perf_counter() - t_all))

    t_card = time.perf_counter() - t0
    cpu_side.defer(modes_card_cpu)
    return admom_launches, admom_rows + psf_rows, modes


# ----------------------------------------------------------------------
# the multi-band, multi-epoch pipeline

MB_KEYS = ("e1", "e2", "T", "flux0", "flux1")


def mb_cols(out, keys=MB_KEYS):
    """e1, e2, T, the band fluxes (keys names them: the last columns,
    after bdf's and bd's extra shape columns), their pars_err, flags and
    nfev of a joint multi-band LM result"""
    n = out["pars"].shape[1]
    idx = [2, 3, 4] + list(range(n - (len(keys) - 3), n))
    cols = dict(zip(keys, out["pars"][:, idx].unbind(-1)))
    return dict(cols, err=out["pars_err"][:, idx], flags=out["flags"], nfev=out["nfev"])


def _epilogue_mb(state, args, conf):
    """the LM result of a K3-mb state on K3-mb's inputs args = (guess,
    lo, hi, psf, band, v, u, ia, ve)"""
    nres = torch.sum(args[7] > 0, dim=(-2, -1))
    return tlm._normal_epilogue(state, args[1], args[2], conf, nres)



def capture_mb_inputs(fn, *args):
    """the inputs of the K3-mb call but the LMConf and of every K2 call
    (gm, v, u, area, fast) of one call fn(*args), and its result"""
    seen = {"k2": []}
    k3mb, k2 = lm_solve.lm_solve_mb, gmix_eval.eval_gmix

    def spy(*a, **kw):
        seen["k3mb"] = a[:9]
        return k3mb(*a, **kw)

    def k2_spy(gm, v, u, area=1.0, fast=True):
        seen["k2"].append((gm, v, u, area, fast))
        return k2(gm, v, u, area, fast=fast)

    with mock.patch.object(lm_solve, "lm_solve_mb", spy), \
            mock.patch.object(gmix_eval, "eval_gmix", k2_spy):
        res = fn(*args)
    return seen, res


def mb_gate(res, het_res, B, nshape=5):
    """bench.py's gate values of a hom and a het mb result of nshape
    shape columns (exp's 5 by default), after the shape, finiteness and
    e1 == pars[:, 2] checks"""
    for r in (res, het_res):
        for t in nt.batch.GALSHEAR_TYPES:
            if not torch.equal(r[t]["e1"], r[t]["pars"][:, 2]):
                raise SmokeFailure("mb e1 is not pars[:, 2] for type %s" % t)
            if tuple(r[t]["pars"].shape) != (B, nshape + nt.sims.MB_NBAND):
                raise SmokeFailure("bad mb pars shape %s" % (tuple(r[t]["pars"].shape),))
            if not bool(torch.isfinite(r[t]["pars"][r[t]["flags"] == 0]).all()):
                raise SmokeFailure("non-finite mb pars for type %s" % t)
    sr, het_sr = nt.shear_response(res), nt.shear_response(het_res)
    return dict(m=m_of(sr), het_m=m_of(het_sr), R11=float(sr["R"][0, 0]),
                flagged=int((res["noshear"]["flags"] != 0).sum()),
                het_flagged=int((het_res["noshear"]["flags"] != 0).sum()))


def mb_against_flat(res, flat):
    """the joint fit of E copies of a stamp against the flat fit of it,
    over lanes unflagged in both: the share whose e1/e2/T differ by more
    than half the flat pars_err and the largest such difference in its
    units; fails unless both band fluxes lie within half the flat flux
    error"""
    share, worst = [], 0.0
    for t in nt.batch.GALSHEAR_TYPES:
        ok = (res[t]["flags"] == 0) & (flat[t]["flags"] == 0)
        err = flat[t]["pars_err"][ok].double()
        d = (res[t]["pars"][ok, 2:5].double() - flat[t]["pars"][ok, 2:5].double()).abs()
        d = d / err[:, 2:5]
        share.append(float((d > 0.5).any(-1).double().mean()))
        worst = max(worst, float(d.max()))
        df = (res[t]["flux"][ok].double() - flat[t]["flux"][ok, None].double()).abs()
        df = df / err[:, 5:6]
        if not bool((df <= 0.5).all()):
            raise SmokeFailure("mb band fluxes differ from the flat fit by %.3e flux errors "
                               "(type %s)" % (float(df.max()), t))
    return max(share), worst


def k3mb_against_plain(args, conf, model="exp", prior=None, plain_lanes=None):
    """K3-mb of the model (with the prior's rows) against its plain
    version on the mb path's float32 solve inputs by phase 13's
    criterion (on the first plain_lanes object-lanes where given).
    Returns the share of lanes outside rtol 1e-4, the largest difference
    in pars_err, the largest absolute difference, the plain version's
    time (ms) and the kernel's state"""
    state = lm_solve.lm_solve_mb(*args, conf, model, prior)
    pa = lanes(args, plain_lanes)
    a = {k: v[:len(pa[0])] for k, v in mb_cols(_epilogue_mb(state, args, conf)).items()}
    plain_state, _, plain_ms = timed_call(lm_solve.lm_solve_mb_plain, *pa, conf, model,
                                          prior)
    b = mb_cols(_epilogue_mb(plain_state, pa, conf))
    flags_diff = int((a["flags"] != b["flags"]).sum())
    split, in_err = f32_split(a, b, MB_KEYS)
    finite = all(bool(torch.isfinite(a[k]).all()) for k in MB_KEYS)
    if not finite or flags_diff or not in_err <= 0.5:
        raise SmokeFailure("K3-mb (%s) disagrees with its plain version on the mb inputs: "
                           "flags differ on %d lanes, largest difference %.3e pars_err, "
                           "finite %s" % (model, flags_diff, in_err, finite))
    max_abs = max(float((a[k].double() - b[k].double()).abs().max()) for k in MB_KEYS)
    return split, in_err, max_abs, plain_ms, state


def mb_k3_checks(args, conf):
    """K3-mb against its plain version on the main path's solve inputs
    (float32, phase 13's criterion), its batch independence, the E = 8
    global-memory case and E = 1 against K3 (float64, phase 12's
    criterion)"""
    split, in_err, max_abs, plain_ms, state = k3mb_against_plain(args, conf)
    indep = check_batch_independence(args, conf, lm_solve.lm_solve_mb)

    a64 = [x.double() if x.dtype.is_floating_point else x for x in args]
    # E = 8 over 64 objects (the planes past shared memory) in six bands,
    # each band's flux guess the first band's
    pick = [0, 1, 2, 0, 1, 2, 0, 1]
    inf = torch.full((11,), torch.inf, dtype=torch.float64, device=args[0].device)
    e8 = (torch.cat([a64[0][:64, :5], a64[0][:64, 5:6].expand(64, 6)], -1).contiguous(),
          -inf, inf, a64[3][:64, pick].contiguous(),
          torch.tensor([0, 1, 2, 3, 4, 5, 0, 1], dtype=torch.int32, device=args[0].device),
          *(x[:64, pick].contiguous() for x in a64[5:]))
    keys8 = ("e1", "e2", "T") + tuple("flux%d" % i for i in range(6))
    d8 = per_lane_diff(mb_cols(_epilogue_mb(lm_solve.lm_solve_mb(*e8, conf), e8, conf), keys8),
                       mb_cols(_epilogue_mb(lm_solve.lm_solve_mb_plain(*e8, conf), e8, conf),
                               keys8),
                       "K3-mb at E = 8 over six bands and its plain version", keys=keys8)
    # E = 1, one band: K3's problem, K3-mb's bad-point convention
    k3_args = (a64[0][:, :6].contiguous(), a64[1][:6], a64[2][:6],
               a64[3][:, 0].contiguous(), *(x[:, 0].contiguous() for x in a64[5:]))
    e1 = (*k3_args[:3], a64[3][:, :1].contiguous(),
          torch.zeros(1, dtype=torch.int32, device=args[0].device),
          *(x[:, :1].contiguous() for x in a64[5:]))
    one = solve_cols(_epilogue_mb(lm_solve.lm_solve_mb(*e1, conf), e1, conf))
    d1 = per_lane_diff(one, solve_columns(lm_solve.lm_solve(*k3_args, conf), k3_args, conf),
                       "K3-mb at E = 1 and K3")
    return dict(split=split, max_in_err=in_err, max_abs_err=max(max_abs, d8[0]),
                plain_ms=plain_ms, indep=indep, e8=d8, e1=d1, lanes=state["nfev"].numel())


def k3mb_bound(args, state, model="exp", prior=None):
    """least time (ms) for K3-mb's work, counted as k3_bound counts K3's:
    the planes, guess, bounds, psf, bands and the prior's table read once
    and the state written once, or K3's operations per pixel and
    gaussian of every epoch at the guess, and prior_ops over all the
    parameters, times each lane's nfev"""
    guess, lo, hi, psf, band, v, u, ia, ve = args
    B, E, P = v.shape
    npars = fit_model.shape_count(model) + 1
    bp = fit_model.epoch_band_pars(model, guess, band).reshape(B * E, npars)
    rp = model_rp(bp, nt.batch._psf_gmix(psf.reshape(B * E, 3)), model)
    per_row = pixel_ops(rp, v.reshape(B * E, P), u.reshape(B * E, P), k3_ops(npars))
    per_lane = per_row.reshape(B, E).sum(-1) + prior_ops(prior, guess.shape[1])
    ops = int((per_lane * state["nfev"].long()).sum())
    esize = v.element_size()
    nbytes = (esize * (4 * B * E * P + guess.numel() + lo.numel() + hi.numel() + psf.numel())
              + band.numel() * band.element_size() + prior_bytes(prior)
              + sum(x.numel() * x.element_size() for x in state.values()))
    return least_ms(nbytes, ops, v.dtype)


def mb_cpu_results(args, band, measure, bounds=None, prior=None):
    """the mb pipeline's float64 results of the LM measure (with the
    prior) on the CPU (its plain version) for args [B, E, ...] and
    band"""
    return nt.make_metacal_pipeline_mb_fn(MB_CONF, band, nt.sims.MB_NBAND, measure=measure,
                                          lm_bounds=bounds, lm_prior=prior, device="cpu")(
                                              *(a.cpu() for a in args))


def mb_card_cpu(args, band, cpu, measure="exp-lm", bounds=None):
    """the mb pipeline in float64 on the card (K3-mb) against the CPU (its
    plain version, cpu: mb_cpu_results of the same arguments) for args
    [B, E, ...] on the card and band, measured by the LM measure inside
    bounds (or unbounded): flags equal, nfev within 2, pars and s2n to
    rtol 1e-8 and atol 1e-10. Returns the largest share of that
    tolerance a difference takes, the largest nfev difference and the
    K3-mb launches of the card call"""
    reset_launches()
    card = nt.make_metacal_pipeline_mb_fn(MB_CONF, band, nt.sims.MB_NBAND, measure=measure,
                                          lm_bounds=bounds, device="cuda")(*args)
    _sync("cuda")
    k3mb = read_launches()["k3mb"]
    worst, dnfev = 0.0, 0
    for t in nt.batch.GALSHEAR_TYPES:
        if not torch.equal(card[t]["flags"].cpu(), cpu[t]["flags"]):
            raise SmokeFailure("mb %s flags differ between card and CPU for %s" % (measure, t))
        dnfev = max(dnfev, int((card[t]["nfev"].cpu() - cpu[t]["nfev"]).abs().max()))
        if dnfev > 2:
            raise SmokeFailure("mb %s nfev differs by %d between card and CPU"
                               % (measure, dnfev))
        worst = max(worst, compare_results({k: card[t][k] for k in ("pars", "s2n")},
                                           {k: cpu[t][k] for k in ("pars", "s2n")},
                                           "mb %s %s" % (measure, t)))
    return worst, dnfev, k3mb


def distinct_epochs(het, n):
    """float64 inputs of n objects whose E epochs are the stamps i + n e
    of het [B, E0, ...] (epoch 0 of each; not copies), and a per-object
    band map"""
    E = len(nt.sims.MB_BAND)
    args = [torch.stack([a[n * e:n * (e + 1), 0] for e in range(E)], 1).double() for a in het]
    band = torch.tensor([[0, 0, 1], [1, 0, 1]], dtype=torch.int32).repeat(n // 2, 1)
    return args, band


def _one_thread():
    """a CpuSide worker's start: one thread, and a lower priority than
    the build's nvcc processes and the main process, so that it takes
    the cores they leave"""
    torch.set_num_threads(1)
    os.nice(10)


def _timed_job(fn, args):
    """fn(*args) and its CPU seconds, in a CpuSide worker"""
    t0 = time.process_time()
    out = fn(*args)
    return out, time.process_time() - t0


def _cat_results(parts):
    """the results of a job's chunks, concatenated along the leading dim
    of every tensor of their nested dicts"""
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], dict):
        return {k: _cat_results([p[k] for p in parts]) for k in parts[0]}
    return torch.cat(parts)


class CpuSide:
    """the float64 CPU sides of the card-against-CPU checks, each
    fn(args on the CPU, *rest) in a spawned worker process of one
    thread, while the card runs the phases before the one that reads
    it; the card side takes the same args"""

    def __init__(self):
        ctx = multiprocessing.get_context("spawn")
        self.pool = ctx.Pool(CPU_WORKERS, initializer=_one_thread)
        self.inputs, self.jobs = {}, {}
        # the seconds the phases waited for results, and each job's CPU
        # seconds in its worker
        self.waited = 0.0
        self.cpu = {}

    def submit(self, key, fn, lanes, *rest):
        """fn(*lanes, *rest) in the workers. lanes are the job's per-lane
        arguments, each a tensor or a list of tensors whose leading dim
        counts the same lanes; every job is split into min(CPU_WORKERS,
        lanes) jobs of consecutive lanes, whose results get()
        concatenates, so that the workers take the phases' CPU sides in
        the order the phases read them. rest goes to every part as it
        is"""
        self.inputs[key] = tuple(lanes) + rest
        sizes = {x.shape[0] for lane in lanes
                 for x in (lane if isinstance(lane, (list, tuple)) else [lane])}
        if len(sizes) > 1:
            raise ValueError("%s: the lane arguments' leading dims differ: %s" % (key, sizes))
        B = sizes.pop() if sizes else 0
        n = max(1, min(CPU_WORKERS, B))
        edges = [B * i // n for i in range(n + 1)]

        def part(x, lo, hi):
            if isinstance(x, (list, tuple)):
                return [a[lo:hi].cpu() for a in x]
            return x[lo:hi].cpu()

        self.jobs[key] = [self.pool.apply_async(_timed_job, (
            fn, tuple(part(x, lo, hi) for x in lanes) + rest))
            for lo, hi in zip(edges[:-1], edges[1:])]

    def get(self, key):
        """the job's inputs (args on the card, *rest) and its result,
        waiting for it"""
        t0 = time.perf_counter()
        parts = [job.get() for job in self.jobs.pop(key)]
        out = _cat_results([p[0] for p in parts])
        self.cpu[key] = sum(p[1] for p in parts)
        waited = time.perf_counter() - t0
        self.waited += waited
        phase = key.split()[0]
        CPU_WAITS[phase] = CPU_WAITS.get(phase, 0.0) + waited
        return self.inputs.pop(key), out

    def cpu_text(self, n=5):
        """the jobs' CPU seconds: their sum and the n costliest"""
        top = sorted(self.cpu.items(), key=lambda x: -x[1])[:n]
        return "%.1f s (%s)" % (sum(self.cpu.values()),
                                ", ".join("%s %.1f" % x for x in top))

    def close(self):
        self.pool.terminate()
        self.pool.join()


def start_cpu_side(device):
    """a CpuSide with the CPU sides of phases 5, 9, 15, 17-24 submitted
    in the order the phases read them, on the phases' sims made here
    from their seeds: the gaussmom, host-loop exp-LM, admom and em
    checks of phases 5, 9, 15 and 20 on the first N_CPU stamps of the exp
    sims (seed 314), phase 17's psf-mode runs, phase 18's mb
    exp-LM, phase 19's pre-psf moments, phase 21's exp-LM in its box
    and mb gauss-lm and dev-lm; phase 22's bdf-lm on phase 21's inputs
    and bd-lm on the bdf-truth sims (bd is degenerate on exp truth:
    log10(Td/Te) has no information at fracdev 0, and its float64 CPU
    run of 256 exp stamps took 450 s on one H100 host core); phase 23's
    prior fits (submit_prior_cpu); phase 24's option pipelines on phase
    21's exp inputs; phase 26's render and phase 27's host fits (made
    from their numpy seed in the worker)"""
    side = CpuSide()
    gen = functools.partial(torch.Generator(device=device).manual_seed)
    nb = nt.sims.MB_NBAND
    hom = nt.make_sim_batch(gen(314), B_MAIN, torch.float32, device=device)
    flat = [a[:N_CPU].double() for a in hom]
    side.submit("5 gaussmom", pipeline_cpu_results, (flat,), CONF, "gaussmom")
    side.submit("9 host-loop", host_loop_cpu_results, (flat,))
    side.submit("15 admom", pipeline_cpu_results, (flat,), ADMOM_CONF, "admom")
    side.submit("20 em", em_cpu_results, (flat[:3],), nt.EMConf())
    for measure, conf in PSF_MODE_RUNS:
        side.submit("17 %s %s" % (measure, conf.psf_mode), pipeline_cpu_results, (flat,), conf,
                    measure)
    het_mb = nt.make_sim_batch_mb(gen(271), B_MB, torch.float32, device=device, hetero=True)
    side.submit("18 mb", mb_cpu_results, distinct_epochs(het_mb, N_CPU_MB), "exp-lm", None)
    del het_mb
    for case in PREPSF_CPU_CASES:
        side.submit("19 %s %s %s" % case, prepsf_cpu_results, (prepsf_cpu_inputs(hom),), *case)
    het = [x[:, None] for x in nt.make_sim_batch_hetero(gen(271), B_MAIN, torch.float32,
                                                          device=device)]
    side.submit("21 exp-lm", flat_cpu_results, (flat,), "exp-lm", BOX)
    mb = distinct_epochs(het, N_CPU_MB_MODELS)
    for model in MODEL_GATES:
        side.submit("21 mb " + model, mb_cpu_results, mb, model + "-lm", None)
    truth = [x[:, None] for x in nt.make_sim_batch_hetero(
        gen(271), B_MAIN, torch.float32, device=device, gal_model="bdf")]
    for model, sims in (("bdf", het), ("bd", truth)):
        box = COMPOSITE[model][0]
        side.submit("22 flat " + model, flat_cpu_results,
                    ([a[:N_CPU_COMPOSITE] for a in flat] if model == "bdf"
                     else [a[:N_CPU_COMPOSITE, 0].double() for a in truth],), model + "-lm", box)
        side.submit("22 mb " + model, mb_cpu_results,
                    distinct_epochs(sims, N_CPU_MB_COMPOSITE), model + "-lm", mb_box(box, nb))
    submit_prior_cpu(side, hom, truth)
    for name, (measure, box, conf, lm_conf) in OPTION_RUNS.items():
        side.submit("24 " + name, option_cpu_results, (flat,), measure, box, conf, lm_conf)
    side.submit("26 render", host_render, (), HOST_RENDER_PARS, "cpu")
    side.submit("27 fitters", fitter_cpu_results, ())
    for group in BOOT_GROUPS:
        side.submit("28 " + group, bootstrap_cpu_results, (), group)
    submit_host_api_cpu(side)
    return side


def mb_phase(device, t_all, cpu_side):
    """phase 18: bench.py's mb workload through K3-mb and its checks.
    Returns the K3-mb row, K2's mb rows, the main path's launches and
    K3-mb's inputs on it but the LMConf"""
    t0 = time.perf_counter()
    fn = nt.make_metacal_pipeline_mb_fn(MB_CONF, nt.sims.MB_BAND, nt.sims.MB_NBAND,
                                        device=device)
    hom = nt.make_sim_batch_mb(torch.Generator(device=device).manual_seed(314), B_MB,
                               torch.float32, device=device)
    het = nt.make_sim_batch_mb(torch.Generator(device=device).manual_seed(271), B_MB,
                               torch.float32, device=device, hetero=True)
    _sync(device)
    reset_launches()
    res = fn(*hom)
    het_res = fn(*het)
    _sync(device)
    launches = read_launches()
    g = mb_gate(res, het_res, B_MB)
    check_gate(g, B_MB, "mb exp-LM")
    reset_launches()
    seen, _ = capture_mb_inputs(fn, *hom)
    _sync(device)
    one = read_launches()
    if launches["k3mb"] != 2 or one["k3mb"] != 1 or one["k2"] <= 0 or one["k3"] != 0:
        raise SmokeFailure("the mb path launched K3-mb %d times in two calls and %d in one, "
                           "K2 %d and K3 %d times in one call, not K3-mb once a call and K2"
                           % (launches["k3mb"], one["k3mb"], one["k2"], one["k3"]))
    sec, (lo, hi), span = timed3(fn, *hom)
    E = len(nt.sims.MB_BAND)
    types = nt.batch.GALSHEAR_TYPES
    nfev = [numiter_stats(*(r[t]["nfev"] for t in types)) for r in (res, het_res)]
    phase_line(
        "18 mb", t0,
        "B=%dx%d m=%.3e hetero_m=%.3e R11=%.4f flagged=%d hetero_flagged=%d launches of the "
        "hom and het calls: k3mb=%d k2=%d; objects/s=%.1f epoch-stamps/s=%.1f (median %.4f "
        "s/call of 3, range %.4f-%.4f)"
        % (B_MB, E, g["m"], g["het_m"], g["R11"], g["flagged"], g["het_flagged"],
           launches["k3mb"], launches["k2"], B_MB / sec, E * B_MB / sec, sec, lo, hi))
    print("    nfev (mean, p50, max): hom (%.3f, %g, %d) het (%.3f, %g, %d); event span "
          "%.3f ms" % (*nfev[0], *nfev[1], span), flush=True)

    flat = nt.make_metacal_pipeline_fn(MB_CONF, measure="exp-lm", device=device)(
        *(a[:, 0] for a in hom))
    share, worst = mb_against_flat(res, flat)
    conf = nt.LMConf()
    args = seen["k3mb"]
    chk = mb_k3_checks(args, conf)
    print("    against the flat exp-LM on the same stamps: %.4f of lanes with e1/e2/T "
          "beyond half the flat pars_err (largest %.3e), band fluxes within it; K3-mb "
          "against its plain version: flags equal, %.4f outside rtol 1e-4, largest "
          "difference %.3e pars_err; bitwise on %d permuted lanes; E=8 (64 objects, 2888 "
          "pixels, 6 bands, float64) max rel %.3e nfev diff %d; E=1 against K3 max rel %.3e "
          "nfev diff %d"
          % (share, worst, chk["split"], chk["max_in_err"], chk["indep"], chk["e8"][1],
             chk["e8"][2], chk["e1"][1], chk["e1"][2]), flush=True)
    (cpu_args, band, _, _), cpu = cpu_side.get("18 mb")
    cpu_worst, cpu_dnfev, _ = mb_card_cpu(cpu_args, band, cpu)

    state = lm_solve.lm_solve_mb(*args, conf)
    ms = time_ms(lambda: lm_solve.lm_solve_mb(*args, conf), K3_TIMED)
    b_ms, by = k3mb_bound(args, state)
    B, _, P = args[5].shape
    attrs = lm_solve.kernel_attrs_mb(args[0].dtype, nt.sims.MB_NBAND, E, P)
    # local memory a thread (spills) at every band count, float32 and 64
    local = {dt: [lm_solve.kernel_attrs_mb(dt, nb, E, P)["local_bytes"] for nb in range(1, 7)]
             for dt in (torch.float32, torch.float64)}
    row = dict(shape="[%dx%dx%d]" % (B, E, P), ms=ms, plain_ms=chk["plain_ms"], bound_ms=b_ms,
               bound_by=by, max_abs_err=chk["max_abs_err"], split=chk["split"],
               max_in_err=chk["max_in_err"], indep=chk["indep"],
               nfev_sum=int(state["nfev"].sum()), attrs=attrs)
    print("    K3-mb %s: %.4f ms, plain %.4f ms, bound %.4f ms (%s), sum nfev %d; %s; local "
          "bytes a thread at nband 1-6: float32 %s, float64 %s"
          % (row["shape"], ms, row["plain_ms"], b_ms, by, row["nfev_sum"], attrs_text(attrs),
             local[torch.float32], local[torch.float64]), flush=True)
    # K2 at the mb shapes: the pooled guess (n = 1 over each object's
    # E P pixels) and the s/n sums (n = 6 fast over the epoch rows)
    k2_in = {(x[0].shape[1], x[4]): x for x in reversed(seen["k2"])}
    k2_rows = []
    for (n, fast), name in (((1, False), "mb guess"), ((6, True), "mb get_loglike")):
        gm, v, u, area, _ = k2_in[(n, fast)]
        r = time_k2("%s n=%d %s [%dx%d]" % (name, n, "fast" if fast else "exact", *v.shape),
                    gm, v, u, area, fast)
        r["launches_a_call"] = sum(1 for x in seen["k2"] if (x[0].shape[1], x[4]) == (n, fast))
        k2_rows.append(r)
        print(k2_row_text(r), flush=True)
    phase_line("18 mb-checks", t0, "256 objects float64 card against CPU: flags equal, nfev "
               "within %d, pars and s2n within rtol 1e-8 + atol 1e-10 (at most %.3e of it); "
               "total %.1f s" % (cpu_dnfev, cpu_worst, time.perf_counter() - t_all))
    return row, k2_rows, launches, args


# ----------------------------------------------------------------------
# the pre-psf moments and EM

PREPSF_FWHM = nt.sims.PREPSF_FWHM
# bench.py's prepsfmom_batch call (bench.py:319-333)
PREPSF_KW = dict(target_dim=4 * nt.sims.DIMS[0], kernel="ksigma", jac_tuple=nt.sims.JAC,
                 fwhm=PREPSF_FWHM)


def prepsf_args(sims):
    """prepsfmom_batch's inputs from a sim batch, as bench.py gives them:
    (images, cens, psf_images, psf_cens, tot_var = NOISE^2)"""
    imgs, _, cens, pimgs, pcens, _ = sims
    tot_var = torch.full((imgs.shape[0],), nt.sims.NOISE**2, dtype=imgs.dtype,
                         device=imgs.device)
    return imgs, cens, pimgs, pcens, tot_var


def timed3(fn, *args):
    """median, min and max wall time (s) and median event span (ms) of
    three calls"""
    runs = [timed_call(fn, *args)[1:] for _ in range(3)]
    w = sorted(r[0] for r in runs)
    return w[1], (w[0], w[2]), sorted(r[1] for r in runs)[1]


def run_prepsfmom(device, hom):
    """bench.py's standalone pre-psf moments: ksigma at target_dim 196
    on the 49x49 stamps, float32, partial modes; three timed calls"""
    args = prepsf_args(hom)
    fn = functools.partial(nt.prepsfmom_batch, device=device, **PREPSF_KW)
    res = fn(*args)
    B = args[0].shape[0]
    ok = res["flags"] == 0
    if not bool(torch.isfinite(res["T"][ok]).all()) or not bool(
            ((res["kernel_nrm"] - 1.0).abs() < 1e-5).all()):
        raise SmokeFailure("prepsfmom_batch: T not finite or kernel_nrm away from 1")
    sec, rng, span = timed3(fn, *args)
    return dict(flagged=int((~ok).sum()), stamps_per_s=B / sec, sec=sec, sec_range=rng,
                span_ms=span)


def run_prepsf_pipelines(device, hom):
    """the pgauss and ksigma metacal pipelines (the gaussmom fields,
    FWHM 2.0) at B_MAIN in float32 with their gates and K2's launches,
    three timed calls each; pgauss under dilate with its gate; K2 on
    the psf render's inputs"""
    B = hom[0].shape[0]
    out, fns = {}, {}
    for measure, conf, m_max in (("pgauss", CONF, 1.5e-3), ("ksigma", CONF, 1.5e-3),
                                 ("pgauss dilate", CONF._replace(psf_mode="dilate"), 3e-3)):
        fn = fns[measure] = nt.make_metacal_pipeline_fn(
            conf, measure=measure.split()[0], measure_fwhm=PREPSF_FWHM, device=device)
        _sync(device)
        reset_launches()
        res = fn(*hom)
        _sync(device)
        launches = read_launches()["k2"]
        for t in conf.types:
            ok = res[t]["flags"] == 0
            if tuple(res[t]["e1"].shape) != (B,) or not bool(
                    torch.isfinite(res[t]["e"][ok]).all()):
                raise SmokeFailure("%s: bad e for type %s" % (measure, t))
        sr = nt.shear_response(res)
        g = dict(m=m_of(sr), R11=float(sr["R"][0, 0]), launches=launches,
                 flagged=int((res["noshear"]["flags"] != 0).sum()))
        sec, rng, span = timed3(fn, *hom)
        g.update(stamps_per_s=B / sec, sec=sec, sec_range=rng)
        if not (abs(g["m"]) < m_max and 1.1 < g["R11"] < 1.8):
            raise SmokeFailure("%s gate failed: m=%.3e R11=%.4f" % (measure, g["m"], g["R11"]))
        check_flagged(dict(g, het_flagged=0), B, measure)
        if conf.psf_mode == "gauss" and launches != 1:
            raise SmokeFailure("the %s path launched K2 %d times, not once (the psf render)"
                               % (measure, launches))
        out[measure] = g
    (gm, v, u, area), launches = capture_k2_inputs(fns["pgauss"], *hom, fast=False)
    row = time_k2("prepsf psf render n=1 exact [%dx%d]" % tuple(v.shape), gm, v, u, area,
                  fast=False)
    row["launches_a_call"] = launches
    return out, row


# phase 19's card-against-CPU cases: (kernel, partial_modes, with the
# sims' noise fields)
PREPSF_CPU_CASES = [(kernel, partial, noisy) for kernel in ("gauss", "ksigma")
                    for partial in (True, False) for noisy in (False, True)]


def prepsf_cpu_inputs(hom, n=N_CPU):
    """the first n stamps' prepsfmom_batch inputs and noise fields in
    float64"""
    return [a[:n].double() for a in prepsf_args(hom)] + [hom[5][:n].double()]


def prepsf_cpu_results(args, kernel, partial, noisy):
    """prepsfmom_batch's float64 results on the CPU for prepsf_cpu_inputs
    args"""
    *args, noise = (a.cpu() for a in args)
    return nt.prepsfmom_batch(*args, noise_images=noise if noisy else None, device="cpu",
                              **dict(PREPSF_KW, kernel=kernel, partial_modes=partial))


def prepsf_card_cpu(cpu_side):
    """the first N_CPU stamps in float64 on the card and the CPU
    (cpu_side's jobs), for pgauss and ksigma, by both routes, with white
    noise and with the sims' noise fields: flags equal, the sums and
    their covariance within rtol 1e-10 and atol 1e-13
    (tests/test_prepsfmom.py:226). Returns the largest share of that
    tolerance"""
    worst = 0.0
    for kernel, partial, noisy in PREPSF_CPU_CASES:
        (args, *_), cpu = cpu_side.get("19 %s %s %s" % (kernel, partial, noisy))
        *args, noise = args
        kw = dict(PREPSF_KW, kernel=kernel, partial_modes=partial)
        card = nt.prepsfmom_batch(*args, noise_images=noise if noisy else None, device="cuda",
                                  **kw)
        what = "prepsfmom %s partial=%s noise=%s" % (kernel, partial, noisy)
        if not torch.equal(card["flags"].cpu(), cpu["flags"]):
            raise SmokeFailure("%s: flags differ between card and CPU" % what)
        for k, sl in (("sums", slice(2, None)), ("sums_cov", slice(None))):
            a, b = card[k][:, sl].cpu(), cpu[k][:, sl]
            tol = 1e-13 + 1e-10 * b.abs()
            err = (a - b).abs()
            if not bool((err <= tol).all()):
                raise SmokeFailure("%s: %s differ between card and CPU: max %.3e"
                                   % (what, k, float(err.max())))
            worst = max(worst, float((err / tol).max()))
    return worst


def check_remap_large(device, N=520):
    """remap_k above MAX_MATMUL_N (the chirp-z route) on one stamp,
    card against CPU in float64, to 1e-10 of the largest |value|"""
    gen = torch.Generator().manual_seed(5)
    khat = torch.complex(torch.randn((1, N, N), generator=gen, dtype=torch.float64),
                         torch.randn((1, N, N), generator=gen, dtype=torch.float64))
    M = nt.batch.kops.kmap_matrix(nt.batch._host_jacobian(CONF),
                                  nt.batch.kops.shear_matrix(0.01, -0.007))
    cpu = nt.batch.kops.remap_k(khat, M)
    card = nt.batch.kops.remap_k(khat.to(device), M).cpu()
    rel = float((card - cpu).abs().max() / cpu.abs().max())
    if not rel <= 1e-10:
        raise SmokeFailure("remap_k at N=%d: card and CPU differ by %.3e" % (N, rel))
    return rel


def prepsf_phase(device, t_all, cpu_side):
    """phase 19: the pre-psf moments, standalone and as metacal
    measures, and their checks. Returns K2's psf-render row and the
    pipelines' results"""
    t0 = time.perf_counter()
    hom = nt.make_sim_batch(torch.Generator(device=device).manual_seed(314), B_MAIN,
                            torch.float32, device=device)
    pp = run_prepsfmom(device, hom)
    pipes, row = run_prepsf_pipelines(device, hom)
    phase_line(
        "19 prepsf", t0,
        "prepsfmom_batch B=%d ksigma target_dim %d: flagged=%d stamps/s=%.1f (median %.4f "
        "s/call of 3, range %.4f-%.4f), event span %.3f ms"
        % (B_MAIN, PREPSF_KW["target_dim"], pp["flagged"], pp["stamps_per_s"], pp["sec"],
           *pp["sec_range"], pp["span_ms"]))
    print("    pipelines B=%d FWHM %.1f: %s" % (B_MAIN, PREPSF_FWHM, "; ".join(
        "%s m=%.3e R11=%.4f flagged=%d k2=%d stamps/s=%.1f (range %.4f-%.4f s)"
        % (k, g["m"], g["R11"], g["flagged"], g["launches"], g["stamps_per_s"], *g["sec_range"])
        for k, g in pipes.items())), flush=True)
    print(k2_row_text(row), flush=True)
    t0 = time.perf_counter()
    worst = prepsf_card_cpu(cpu_side)
    rel = check_remap_large(device)
    phase_line("19 prepsf-cpu", t0, "256 stamps float64 card against CPU, pgauss and ksigma "
               "by both routes, white and measured noise: flags equal, sums and covariance "
               "within rtol 1e-10 + atol 1e-13 (at most %.3e of it); remap_k N=520 (chirp-z) "
               "max rel %.3e; total %.1f s" % (worst, rel, time.perf_counter() - t_all))
    return row, pipes


def em_cpu_results(args, conf):
    """em_batch's float64 results on the CPU for the em1 inputs of the
    stamps args (images, weights, cens)"""
    return nt.em_batch(*nt.sims.em1_inputs(*(a.cpu() for a in args)), conf, device="cpu")


def em_phase(device, t_all, cpu_side):
    """phase 20: bench.py's em1 workload (em_batch of one gaussian on
    the sky-shifted 49x49 stamps, default EMConf) in float32, and 256
    stamps in float64 card against CPU (the CPU side from cpu_side)"""
    t0 = time.perf_counter()
    hom = nt.make_sim_batch(torch.Generator(device=device).manual_seed(314), B_MAIN,
                            torch.float32, device=device)
    args = nt.sims.em1_inputs(*hom[:3])
    conf = nt.EMConf()
    fn = functools.partial(nt.em_batch, conf=conf, device=device)
    res = fn(*args)
    ok = res["flags"] == 0
    if tuple(res["gmix"].shape) != (B_MAIN, 1, 6) or not bool(
            torch.isfinite(res["gmix"][ok]).all()):
        raise SmokeFailure("em_batch: bad gmix shape or not finite")
    sec, rng, span = timed3(fn, *args)
    it = res["numiter"].double()
    q = [float(torch.quantile(it, x)) for x in (0.5, 0.9, 0.99)]
    phase_line("20 em", t0, "em_batch B=%d 49x49 float32: flagged=%d (maxiter %d) "
               "stamps/s=%.1f (median %.4f s/call of 3, range %.4f-%.4f); numiter (mean, p50, "
               "p90, p99, max): %.3f, %g, %g, %g, %d (the host loop's iterations a call); "
               "event span %.3f ms"
               % (B_MAIN, int((~ok).sum()), int((res["numiter"] >= conf.maxiter).sum()),
                  B_MAIN / sec, sec, *rng, float(it.mean()), *q, int(it.max()), span))
    t0 = time.perf_counter()
    (args64, _), cpu = cpu_side.get("20 em")
    card = nt.em_batch(*nt.sims.em1_inputs(*args64), conf, device="cuda")
    worst = compare_results({k: card[k] for k in ("gmix", "gmix_conv", "sky", "numiter",
                                                  "flags")},
                            {k: cpu[k] for k in ("gmix", "gmix_conv", "sky", "numiter",
                                                 "flags")}, "em")
    # fdiff is 0 on lanes that reach a fixed point, so its difference
    # is printed absolute
    fd = float((card["fdiff"].cpu() - cpu["fdiff"]).abs().max())
    phase_line("20 em-cpu", t0, "256 stamps float64: flags and numiter equal (max %d), gmix, "
               "gmix_conv and sky within rtol 1e-8 + atol 1e-10 (at most %.3e of it), fdiff "
               "max abs diff %.3e; total %.1f s"
               % (int(cpu["numiter"].max()), worst, fd, time.perf_counter() - t_all))


# ----------------------------------------------------------------------
# the gauss and dev LM models and bounds

# each model's |m| and |hetero m| limit: phase 8's for gauss, the
# reference's for dev, a misspecified model of exp galaxies
# (tests/test_batch_pipeline.py:304-318)
MODEL_GATES = {"gauss": 1e-3, "dev": 3e-3}
# the reference's bounds box (tests/test_batch_pipeline.py:394-395)
BOX = ([-1.0, -1.0, -0.99, -0.99, 0.01, 1e-4], [1.0, 1.0, 0.99, 0.99, 10.0, 1e9])


def run_model(device, model, hom, het):
    """the model's LM main path (through K3) in float32 on both sims with
    its gate and launches; three timed calls; then K3 on its captured
    solve inputs against its plain version by phase 13's criterion (and
    timed), and on 256 of them in float64 by phase 12's"""
    fn = nt.make_metacal_pipeline_fn(LM_CONF, measure=model + "-lm", device=device)
    _sync(device)
    reset_launches()
    res = fn(*hom)
    het_res = fn(*het)
    _sync(device)
    launches = read_launches()
    g = exp_lm_gate(res, het_res, B_MAIN)
    if not (abs(g["m"]) < MODEL_GATES[model] and abs(g["het_m"]) < MODEL_GATES[model]):
        raise SmokeFailure("%s-lm m gate failed: m=%.3e hetero m=%.3e > %g"
                           % (model, g["m"], g["het_m"], MODEL_GATES[model]))
    check_flagged(g, B_MAIN, model + "-lm")
    if launches["k3"] != 2 or launches["k2"] <= 0 or launches["k1"] != 0:
        raise SmokeFailure("the %s-lm path launched K3 %d times in two calls, K2 %d and K1 %d"
                           % (model, launches["k3"], launches["k2"], launches["k1"]))
    sec, (lo, hi), _ = timed3(fn, *hom)
    types = nt.batch.GALSHEAR_TYPES
    nfev = numiter_stats(*(r[t]["nfev"] for r in (res, het_res) for t in types))
    conf = nt.LMConf()
    args, _ = capture_k3_inputs(hom, device, measure=model + "-lm")
    row = k3_timed_row(args, conf, model, plain_lanes=PLAIN_LANES)
    row["attrs"] = lm_solve.kernel_attrs(args[0].dtype, args[4].shape[1], model)
    a64 = tuple((x if x.dim() == 1 else x[:256]).double().contiguous() for x in args)
    d64 = per_lane_diff(solve_columns(lm_solve.lm_solve(*a64, conf, model), a64, conf),
                        solve_columns(lm_solve.lm_solve_plain(*a64, conf, model), a64, conf),
                        "K3 (%s) and its plain version in float64" % model)
    return dict(g, launches=launches, stamps_per_s=B_MAIN / sec, sec_range=(lo, hi),
                nfev=nfev, row=row, d64=d64), fn


def k3mb_model_row(args, conf, model, prior=None):
    """K3-mb of the model (with the prior's rows) on the mb path's
    float32 solve inputs (its guess is the moments guess of every model)
    against its plain version by phase 13's criterion on the first
    PLAIN_LANES_MB object-lanes, and timed beside its bound"""
    split, in_err, max_abs, plain_ms, state = k3mb_against_plain(args, conf, model, prior,
                                                                 PLAIN_LANES_MB)
    ms = time_ms(lambda: lm_solve.lm_solve_mb(*args, conf, model, prior), K3_TIMED)
    b_ms, by = k3mb_bound(args, state, model, prior)
    B, E, P = args[5].shape
    nband = args[0].shape[1] - nt.fitting.fit_model.shape_count(model)
    return dict(shape="%s NG=%d [%dx%dx%d]%s" % (model, NGAUSS[model], B, E, P,
                                                prior_text(prior)), ms=ms,
                plain_ms=plain_ms, plain_lanes=min(PLAIN_LANES_MB, B), bound_ms=b_ms,
                bound_by=by, max_abs_err=max_abs, split=split, max_in_err=in_err,
                nfev_sum=int(state["nfev"].sum()),
                attrs=lm_solve.kernel_attrs_mb(args[0].dtype, nband, E, P, model))


def flat_cpu_results(args, measure, box, prior=None):
    """the LM measure's float64 results inside the box (with the prior)
    on the CPU (its plain version) for the stamps args"""
    return nt.make_metacal_pipeline_fn(LM_CONF, measure=measure, lm_bounds=box,
                                       lm_prior=prior, device="cpu")(*(a.cpu() for a in args))


def bounded_card_cpu(args, cpu, measure="exp-lm", box=BOX):
    """the LM measure (exp-LM by default) inside its bounds box (the
    reference's, tests/test_batch_pipeline.py:394-395, by default) on
    the float64 stamps args on the card (K3) against the CPU (its plain
    version, cpu: flat_cpu_results of args): flags equal, nfev within 2,
    pars to rtol 1e-8 and atol 1e-10, every pars inside the box. Returns
    the largest share of that tolerance a difference takes, the largest
    nfev difference and the card call's K3 launches"""
    reset_launches()
    card = nt.make_metacal_pipeline_fn(LM_CONF, measure=measure, lm_bounds=box,
                                       device="cuda")(*args)
    _sync("cuda")
    k3 = read_launches()["k3"]
    lo, hi = (torch.tensor(x, dtype=torch.float64) for x in box)
    worst, dnfev = 0.0, 0
    for t in nt.batch.GALSHEAR_TYPES:
        if not torch.equal(card[t]["flags"].cpu(), cpu[t]["flags"]):
            raise SmokeFailure("bounded %s flags differ between card and CPU for %s"
                               % (measure, t))
        dnfev = max(dnfev, int((card[t]["nfev"].cpu() - cpu[t]["nfev"]).abs().max()))
        if dnfev > 2:
            raise SmokeFailure("bounded %s nfev differs by %d between card and CPU"
                               % (measure, dnfev))
        worst = max(worst, compare_results({"pars": card[t]["pars"]}, {"pars": cpu[t]["pars"]},
                                           "bounded %s %s" % (measure, t)))
        pars = card[t]["pars"][card[t]["flags"] == 0].cpu()
        if not bool(((pars > lo) & (pars < hi)).all()):
            raise SmokeFailure("bounded %s pars outside the box for %s" % (measure, t))
    return worst, dnfev, k3


def models_phase(device, t_all, mb_args, cpu_side):
    """phase 21: the gauss-lm and dev-lm main paths through K3 with their
    gates, K3 at NG = 1 and 10 against its plain version and timed, K3-mb
    at NG = 1 and 10 on the mb path's inputs, K2 at dev's s/n sums, and
    card against CPU in float64 for exp-LM in the reference's bounds box
    and the mb pipeline with gauss-lm and dev-lm. Returns K3's and
    K3-mb's rows and launches by path, and K2's row"""
    t0 = time.perf_counter()
    hom = nt.make_sim_batch(torch.Generator(device=device).manual_seed(314), B_MAIN,
                            torch.float32, device=device)
    het = nt.make_sim_batch_hetero(torch.Generator(device=device).manual_seed(271),
                                   B_MAIN, torch.float32, device=device)
    runs, fns = {}, {}
    for model in MODEL_GATES:
        runs[model], fns[model] = run_model(device, model, hom, het)
    k2_row = time_k2_captured("dev-lm get_loglike", fns["dev"], *hom, pixels=361)
    conf = nt.LMConf()
    mb_rows = {model: k3mb_model_row(mb_args, conf, model) for model in MODEL_GATES}
    phase_line("21 models", t0, "B=%d float32 through K3: %s" % (B_MAIN, "; ".join(
        "%s-lm m=%.3e hetero_m=%.3e (|m| < %g) R11=%.4f flagged=%d hetero_flagged=%d "
        "launches of the hom and het calls: k3=%d k2=%d; stamps/s=%.1f (range %.4f-%.4f s); "
        "nfev (mean, p50, max) (%.3f, %g, %d)"
        % (m, r["m"], r["het_m"], MODEL_GATES[m], r["R11"], r["flagged"], r["het_flagged"],
           r["launches"]["k3"], r["launches"]["k2"], r["stamps_per_s"], *r["sec_range"],
           *r["nfev"]) for m, r in runs.items())))

    t1 = time.perf_counter()
    (b_args, _, _), cpu = cpu_side.get("21 exp-lm")
    b_worst, b_dnfev, b_k3 = bounded_card_cpu(b_args, cpu)
    mb_cpu, mb_launches = {}, {}
    for model in MODEL_GATES:
        (args, band, measure, _), cpu = cpu_side.get("21 mb " + model)
        *mb_cpu[model], mb_launches[model] = mb_card_cpu(args, band, cpu, measure)
    print("    %s; K2 %s: %.4f ms, plain %.4f ms, bound %.4f ms (%s), %d launches a call; "
          "card against CPU in float64, 256 stamps: exp-lm in the bounds box (k3=%d) "
          "flags equal, nfev within %d, pars within rtol 1e-8 + atol 1e-10 (at most %.3e "
          "of it); mb %d objects x 3 epochs %s; %.1f s, total %.1f s"
          % ("; ".join(
              "K3 %s: %.4f ms, plain %.4f ms (%d lanes), bound %.4f ms (%s), sum nfev %d, "
              "%.4f outside rtol 1e-4, within %.3e pars_err, float64 256 lanes max rel %.3e "
              "nfev diff %d; %s"
              % (r["row"]["shape"], r["row"]["ms"], r["row"]["plain_ms"], r["row"]["plain_lanes"],
                 r["row"]["bound_ms"], r["row"]["bound_by"], r["row"]["nfev_sum"],
                 r["row"]["split"], r["row"]["max_in_err"], r["d64"][1], r["d64"][2],
                 attrs_text(r["row"]["attrs"]))
              for r in runs.values()) + "; " + "; ".join(
              "K3-mb %s: %.4f ms, plain %.4f ms (%d object-lanes), bound %.4f ms (%s), sum "
              "nfev %d, within %.3e pars_err; %s" % (r["shape"], r["ms"], r["plain_ms"],
                                                      r["plain_lanes"], r["bound_ms"],
                                                      r["bound_by"], r["nfev_sum"],
                                                      r["max_in_err"], attrs_text(r["attrs"]))
              for r in mb_rows.values()),
             k2_row["shape"], k2_row["ms"], k2_row["plain_ms"], k2_row["bound_ms"],
             k2_row["bound_by"], k2_row["launches_a_call"], b_k3, b_dnfev, b_worst,
             N_CPU_MB_MODELS,
             ", ".join("%s-lm (k3mb=%d) flags equal, nfev within %d, pars and s2n at most "
                       "%.3e of rtol 1e-8 + atol 1e-10" % (m, mb_launches[m], d, w)
                       for m, (w, d) in mb_cpu.items()),
             time.perf_counter() - t1, time.perf_counter() - t_all), flush=True)
    if b_k3 != 1 or any(n != 1 for n in mb_launches.values()):
        raise SmokeFailure("card against CPU: the bounded exp-LM call launched K3 %d times, "
                           "the mb calls K3-mb %s" % (b_k3, mb_launches))
    return dict(
        k3_rows=[r["row"] for r in runs.values()],
        k3_launches=dict({"%s-lm" % m: r["launches"]["k3"] for m, r in runs.items()},
                         **{"exp-lm bounded": b_k3}),
        k3mb_rows=list(mb_rows.values()),
        k3mb_launches={"mb %s-lm" % m: n for m, n in mb_launches.items()},
        k2_row=k2_row,
        k2_launches={"%s-lm" % m: r["launches"]["k2"] for m, r in runs.items()},
        max_abs_err=max(max(r["row"]["max_abs_err"], r["d64"][0]) for r in runs.values()),
        mb_max_abs_err=max(r["max_abs_err"] for r in mb_rows.values()),
    )


# ----------------------------------------------------------------------
# the composite bulge+disk models

# each composite model's box (bdf's production bounds, the reference's bd
# box: sims.BDF_LM_BOUNDS, BD_LM_BOUNDS) and |m| limit: bench.py's for
# bdf, the reference's only bd bound for bd
# (tests/test_batch_pipeline.py:372)
COMPOSITE = {"bdf": (nt.sims.BDF_LM_BOUNDS, 1e-3), "bd": (nt.sims.BD_LM_BOUNDS, 3e-3)}


def mb_box(box, nband):
    """a flat box with its flux bounds repeated once a band, as
    tools/validate_scale.py:436-442 extends bdf's to two bands"""
    return tuple(list(x[:-1]) + [x[-1]] * nband for x in box)


def run_composite(device, model, hom, het):
    """the composite model's LM main path (through K3) inside its box in
    float32 on the exp sims (fracdev on its bound) and the bdf-truth
    sims, gated, with its launches, and three timed calls"""
    box, limit = COMPOSITE[model]
    fn = nt.make_metacal_pipeline_fn(LM_CONF, measure=model + "-lm", lm_bounds=box,
                                     device=device)
    _sync(device)
    reset_launches()
    res = fn(*hom)
    het_res = fn(*het)
    _sync(device)
    launches = read_launches()
    g = exp_lm_gate(res, het_res, B_MAIN, npars=len(box[0]))
    if not (abs(g["m"]) < limit and abs(g["het_m"]) < limit):
        raise SmokeFailure("%s-lm m gate failed: m=%.3e hetero m=%.3e > %g"
                           % (model, g["m"], g["het_m"], limit))
    check_flagged(g, B_MAIN, model + "-lm")
    if launches["k3"] != 2 or launches["k2"] <= 0 or launches["k1"] != 0:
        raise SmokeFailure("the %s-lm path launched K3 %d times in two calls, K2 %d and K1 %d"
                           % (model, launches["k3"], launches["k2"], launches["k1"]))
    sec, (lo, hi), _ = timed3(fn, *hom)
    types = nt.batch.GALSHEAR_TYPES
    nfev = numiter_stats(*(r[t]["nfev"] for r in (res, het_res) for t in types))
    fracdev = [float(torch.cat([r[t]["fracdev"][r[t]["flags"] == 0] for t in types]).mean())
               for r in (res, het_res)]
    return dict(g, launches=launches, stamps_per_s=B_MAIN / sec, sec_range=(lo, hi),
                nfev=nfev, fracdev=fracdev), fn


# ROADMAP fault 3.4: on the exp sims, where bdf's fracdev sits on its
# bound and bd's log10(Td/Te) is then free, float32 LM solves stop early
# on rare lanes, K3's and its plain version's alike (and the JAX
# package's float32 LM at the same rate, scripts/fault34_f32_stops.py:
# the algorithm's), and float64 solves by two routes part in nfev where
# the fracdev pin toggles at a near-tie. The checks on those inputs
# count such lanes. In float32:
# the lanes farther than half a pars_err from the float64 optimum (the
# kernel's own float64 solve of the same inputs, held to its plain
# version by f64_lanes), at most max(8, 1e-4 of the lanes) for bdf and
# 5% for bd, degenerate there, and none beyond F32_MAX_ERR pars_err.
# Measured on an H100 (flat 51,200 lanes, mb 10,240): bdf 1 lane by K3
# and 1 by its plain version flat (3.9 and 1.3 pars_err), none mb; bd
# 229 and 238 flat (3.7 and 7.5), 225 and 252 mb (4.1 and 6.1)
F32_LIMIT = {"bdf": lambda n: max(8, n // 10000), "bd": lambda n: n // 20}
F32_MAX_ERR = 10.0


def beyond_optimum(kind, a, opt, keys, what, limits=F32_LIMIT, ref="the float64 optimum"):
    """hold a float32 LM result a to the float64 optimum opt (solve_cols
    or mb_cols of the same inputs, keys their columns; or to another
    reference, named by ref): flags equal on every lane; of the lanes
    unflagged, those whose keys lie farther than half of opt's pars_err
    at most limits[kind] (F32_LIMIT: by composite model), none farther
    than F32_MAX_ERR. Returns that count and the largest distance in
    pars_err"""
    if not torch.equal(a["flags"], opt["flags"]):
        raise SmokeFailure("%s: flags differ from %s on %d lanes"
                           % (what, ref, int((a["flags"] != opt["flags"]).sum())))
    ok = opt["flags"] == 0
    d = torch.stack([(a[k].double() - opt[k]).abs() / opt["err"][:, i]
                     for i, k in enumerate(keys)], -1)[ok].max(-1).values
    n, worst, limit = int((d > 0.5).sum()), float(d.max()), limits[kind](ok.numel())
    if n > limit or not worst <= F32_MAX_ERR:
        raise SmokeFailure("%s: %d lanes beyond half a pars_err of %s (limit %d), "
                           "largest %.3f pars_err (limit %g)"
                           % (what, n, ref, limit, worst, F32_MAX_ERR))
    return n, worst


def f64_lanes(a, b, what, keys=("pars",)):
    """two float64 LM results of the same lanes (dicts of flags, nfev,
    pars_err and keys; b the reference) by fault 3.4's criterion: flags
    equal on every lane; keys (pars, and s2n where given) within rtol
    1e-8 + atol 1e-10 with NaNs in the same places, except on at most
    max(4, 1%) of the lanes, where every parameter lies within that
    tolerance or within a thousandth of its pars_err and s2n within rtol
    1e-5; nfev within 2 except on at most as many lanes. Returns the
    largest absolute pars difference, the largest share of the
    tolerance on the lanes not excepted, the excepted lanes, the largest
    difference on them in pars_err, the lanes whose nfev differ by more
    than 2 and the largest nfev difference"""
    a, b = ({k: r[k].cpu() for k in ("flags", "nfev", "pars_err") + keys} for r in (a, b))
    if not torch.equal(a["flags"], b["flags"]):
        raise SmokeFailure("%s: flags differ on %d lanes"
                           % (what, int((a["flags"] != b["flags"]).sum())))
    n = a["flags"].numel()
    limit = max(4, n // 100)
    x = {}
    for k in keys:
        xa, xb = (r[k].double().reshape(n, -1) for r in (a, b))
        if not torch.equal(torch.isnan(xa), torch.isnan(xb)):
            raise SmokeFailure("%s: NaNs of %s differ" % (what, k))
        x[k] = (torch.nan_to_num(xa), torch.nan_to_num(xb))
    share = torch.stack([((xa - xb).abs() / (1e-10 + 1e-8 * xb.abs())).max(-1).values
                         for xa, xb in x.values()], -1).max(-1).values
    exc = share > 1
    pa, pb = x["pars"]
    d = (pa - pb).abs()
    err = torch.nan_to_num(b["pars_err"].double())
    in_tol = d <= 1e-10 + 1e-8 * pb.abs()
    excused = (in_tol | (d <= 1e-3 * err)).all(-1)
    if "s2n" in x:
        sa, sb = x["s2n"]
        excused &= ((sa - sb).abs() <= 1e-5 * sb.abs()).all(-1)
    in_err = torch.where(in_tol, torch.zeros_like(d), d / err).max(-1).values
    dn = (a["nfev"] - b["nfev"]).abs()
    out = dict(max_abs=float(d.max()), share=float(share[~exc].max()) if bool((~exc).any())
               else 0.0, excepted=int(exc.sum()),
               excepted_err=float(in_err[exc].max()) if bool(exc.any()) else 0.0,
               nfev_far=int((dn > 2).sum()), dnfev=int(dn.max()), limit=limit)
    if out["excepted"] > limit or not bool(excused[exc].all()):
        raise SmokeFailure("%s: %d of %d lanes outside rtol 1e-8 + atol 1e-10 (limit %d), "
                           "up to %.3e pars_err" % (what, out["excepted"], n, limit,
                                                    out["excepted_err"]))
    if out["nfev_far"] > limit:
        raise SmokeFailure("%s: nfev differs by more than 2 on %d of %d lanes (limit %d), up "
                           "to %d" % (what, out["nfev_far"], n, limit, out["dnfev"]))
    return out


def f64_text(r):
    return ("%d excepted (%.2e pars_err), nfev > 2 apart on %d (max %d), else within %.2e "
            "of rtol 1e-8" % (r["excepted"], r["excepted_err"], r["nfev_far"], r["dnfev"],
                              r["share"]))


def lm_result(state, args, conf):
    """the LM result of a K3 state on K3's inputs args"""
    return tlm._normal_epilogue(state, args[1], args[2], conf, torch.sum(args[6] > 0, dim=-1))


def float64(args):
    """K3's or K3-mb's inputs with the floating ones in float64"""
    return tuple((x.double() if x.dtype.is_floating_point else x).contiguous() for x in args)


def first_lanes(args, n=256):
    """the first n lanes of K3's or K3-mb's inputs, in float64"""
    return float64(x if x.dim() == 1 else x[:n] for x in args)


def eager_steps():
    """a context in which the LM loops step eagerly on the card, not by
    replaying a captured CUDA graph of the step"""
    stepper = tlm._stepper
    return mock.patch.object(tlm, "_stepper", lambda step, s, graph: stepper(step, s, False))


def replay_check(args, model, mb=False):
    """the plain solve (mb: K3-mb's) of the first 64 lanes of K3's
    inputs args in float64 for 8 iterations, its steps replayed from a
    CUDA graph, against the same solve's eager steps: every state tensor
    bitwise equal"""
    a = first_lanes(args, 64)
    conf = nt.LMConf(maxfev=8)
    plain = lm_solve.lm_solve_mb_plain if mb else lm_solve.lm_solve_plain
    replayed = plain(*a, conf, model)
    with eager_steps():
        eager = plain(*a, conf, model)
    differ = [k for k in eager if not torch.equal(eager[k], replayed[k])]
    if differ:
        raise SmokeFailure("the plain %s%s solve's replayed steps differ from its eager "
                           "steps in %s" % ("mb " if mb else "", model, differ))


def joint_first_lanes(paths, n=256):
    """the first n lanes of each path's K3 or K3-mb inputs in float64,
    stacked into one batch (the paths' shared 1-d inputs, lo and hi,
    equal), and each path's slice of it: one kernel solve and one plain
    solve hold every path, the plain version's host loop running as
    long as its slowest lane instead of once a path"""
    parts = [first_lanes(a, n) for a in paths]
    for p in parts[1:]:
        if not all(torch.equal(x, y) for x, y in zip(parts[0], p) if x.dim() == 1):
            raise SmokeFailure("the paths' shared inputs differ")
    joint = tuple(x if x.dim() == 1 else torch.cat([p[i] for p in parts])
                  for i, x in enumerate(parts[0]))
    ends = np.cumsum([0] + [p[0].shape[0] for p in parts])
    return joint, [slice(a, b) for a, b in zip(ends[:-1], ends[1:])]


def rows(result, sl):
    """the lanes sl of every column of a result dict"""
    return {k: v[sl] for k, v in result.items()}


def plain64(paths, model, mb=False, prior=None):
    """the float64 check of K3 (mb: K3-mb) against its plain version on
    the first 256 lanes of every path, stacked (joint_first_lanes): the
    inputs, each path's slice, and the plain solve's state"""
    joint, slices = joint_first_lanes(paths)
    plain = lm_solve.lm_solve_mb_plain if mb else lm_solve.lm_solve_plain
    return joint, slices, plain(*joint, nt.LMConf(), model, prior)


def composite_k3_row(model, args):
    """K3 of the composite model on the bdf-truth path's float32 solve
    inputs args against its plain version by phase 13's criterion,
    timed beside its bound, with its registers and local memory"""
    row = k3_timed_row(args, nt.LMConf(), model, plain_lanes=PLAIN_LANES)
    row["attrs"] = lm_solve.kernel_attrs(args[0].dtype, args[4].shape[1], model)
    return row


def composite_k3_checks(model, args, exp_args):
    """K3 of the composite model on the exp path's float32 solve inputs
    exp_args against its float64 solve (beyond_optimum), and on 256
    lanes of each path (args: the bdf-truth path's) in float64 against
    its plain version (f64_lanes; both paths' lanes in one solve,
    plain64). Returns the two checks' numbers"""
    conf = nt.LMConf()
    paths = (args, exp_args)
    e64 = float64(exp_args)
    f32 = beyond_optimum(
        model, solve_columns(lm_solve.lm_solve(*exp_args, conf, model), exp_args, conf),
        solve_columns(lm_solve.lm_solve(*e64, conf, model), e64, conf),
        ("e1", "e2", "T", "flux"), "K3 (%s) in float32 on the exp path" % model)
    joint, slices, plain = plain64(paths, model)
    kern = lm_result(lm_solve.lm_solve(*joint, conf, model), joint, conf)
    plain = lm_result(plain, joint, conf)
    f64 = [f64_lanes(rows(kern, sl), rows(plain, sl),
                     "K3 (%s) and its plain version in float64 on the %s path" % (model, name))
           for name, sl in zip(("bdf-truth", "exp"), slices)]
    return f32, f64


def run_composite_mb(device, model, hom, het):
    """the mb pipeline with the composite model inside its box extended
    to the bands (through K3-mb) in float32 on the mb exp sims and the
    mb bdf-truth sims, gated as run_composite, with K3-mb launched once
    a call. Returns the gate values, the launches and K3-mb's inputs on
    the het and the hom call"""
    box, limit = COMPOSITE[model]
    nb = nt.sims.MB_NBAND
    fn = nt.make_metacal_pipeline_mb_fn(MB_CONF, nt.sims.MB_BAND, nb, measure=model + "-lm",
                                        lm_bounds=mb_box(box, nb), device=device)
    _sync(device)
    reset_launches()
    res = fn(*hom)
    het_res = fn(*het)
    _sync(device)
    launches = read_launches()
    g = mb_gate(res, het_res, B_MB, nshape=len(box[0]) - 1)
    if not (abs(g["m"]) < limit and abs(g["het_m"]) < limit):
        raise SmokeFailure("mb %s-lm m gate failed: m=%.3e hetero m=%.3e > %g"
                           % (model, g["m"], g["het_m"], limit))
    check_flagged(g, B_MB, "mb %s-lm" % model)
    if launches["k3mb"] != 2 or launches["k2"] <= 0 or launches["k3"] != 0:
        raise SmokeFailure("the mb %s-lm path launched K3-mb %d times in two calls, K2 %d and "
                           "K3 %d" % (model, launches["k3mb"], launches["k2"], launches["k3"]))
    return dict(g, launches=launches), [capture_mb_inputs(fn, *x)[0]["k3mb"] for x in (het, hom)]


def composite_k3mb_row(model, args):
    """K3-mb of the composite model on the mb bdf-truth path's float32
    solve inputs args against its plain version by phase 13's
    criterion, timed beside its bound, with its registers and its local
    memory at nband 1-6"""
    row = k3mb_model_row(args, nt.LMConf(), model)
    E, P = args[5].shape[1:]
    row["attrs"] = lm_solve.kernel_attrs_mb(torch.float32, nt.sims.MB_NBAND, E, P, model)
    # registers, local bytes and blocks an SM at nband 1-6, float32 and 64
    row["nband_attrs"] = {str(dt)[6:]: [lm_solve.kernel_attrs_mb(dt, n, E, P, model)
                                        for n in range(1, 7)]
                          for dt in (torch.float32, torch.float64)}
    return row


def nband_text(attrs):
    """registers/local bytes/blocks an SM at nband 1-6, float32 then
    float64"""
    return "; ".join("%s %s" % (name, " ".join("%d/%d/%d" % (a["regs"], a["local_bytes"],
                                                              a["blocks_per_sm"]) for a in rows))
                     for name, rows in attrs.items())


def composite_k3mb_checks(model, args, exp_args):
    """K3-mb of the composite model as composite_k3_checks holds K3: on
    the mb exp path's float32 solve inputs exp_args against its float64
    solve, and on 256 object-lanes of each path in float64 against its
    plain version (both in one solve, plain64)"""
    conf = nt.LMConf()
    paths = (args, exp_args)
    e64 = float64(exp_args)
    f32 = beyond_optimum(
        model, mb_cols(_epilogue_mb(lm_solve.lm_solve_mb(*exp_args, conf, model), exp_args,
                                    conf)),
        mb_cols(_epilogue_mb(lm_solve.lm_solve_mb(*e64, conf, model), e64, conf)), MB_KEYS,
        "K3-mb (%s) in float32 on the mb exp path" % model)
    joint, slices, plain = plain64(paths, model, mb=True)
    kern = _epilogue_mb(lm_solve.lm_solve_mb(*joint, conf, model), joint, conf)
    plain = _epilogue_mb(plain, joint, conf)
    f64 = [f64_lanes(rows(kern, sl), rows(plain, sl),
                     "K3-mb (%s) and its plain version in float64 on the mb %s path"
                     % (model, name)) for name, sl in zip(("bdf-truth", "exp"), slices)]
    return f32, f64


def cat_types(res, keys):
    return {k: torch.cat([res[t][k] for t in nt.batch.GALSHEAR_TYPES]) for k in keys}


def composite_card_cpu(cpu_side, kind, model):
    """card against CPU in float64 for the composite model's flat or mb
    pipeline on the inputs of its CpuSide job: f64_lanes over the five
    types' lanes with s2n, and unflagged pars inside the box. Returns
    f64_lanes' numbers, the card call's K3 or K3-mb launches and the
    stamps or objects"""
    inputs, cpu = cpu_side.get("22 %s %s" % (kind, model))
    reset_launches()
    if kind == "flat":
        args, measure, box = inputs
        card = nt.make_metacal_pipeline_fn(LM_CONF, measure=measure, lm_bounds=box,
                                           device="cuda")(*args)
    else:
        args, band, measure, box = inputs
        card = nt.make_metacal_pipeline_mb_fn(MB_CONF, band, nt.sims.MB_NBAND, measure=measure,
                                              lm_bounds=box, device="cuda")(*args)
    _sync("cuda")
    launches = read_launches()["k3" if kind == "flat" else "k3mb"]
    keys = ("flags", "nfev", "pars_err", "pars", "s2n")
    a = cat_types(card, keys)
    out = f64_lanes(a, cat_types(cpu, keys), "%s %s-lm card against CPU" % (kind, model),
                    ("pars", "s2n"))
    lo, hi = (torch.tensor(x, dtype=torch.float64) for x in box)
    pars = a["pars"][a["flags"] == 0].cpu()
    if not bool(((pars > lo) & (pars < hi)).all()):
        raise SmokeFailure("%s %s-lm pars outside the box" % (kind, model))
    return out, launches, args[0].shape[0]


def composite_phase(device, t_all, cpu_side):
    """phase 22: bdf-lm (production bounds) and bd-lm (the reference's
    box) through K3 on the exp and bdf-truth sims, the mb pipeline with
    both through K3-mb, each gated; K3 and K3-mb at both models against
    their plain versions and timed (composite_k3_checks,
    composite_k3mb_checks); K2 at bdf's s/n sums; card against CPU in
    float64, flat and mb, from cpu_side. Returns K3's and K3-mb's rows
    and launches by path, and K2's row and launches"""
    t0 = time.perf_counter()
    gen = functools.partial(torch.Generator(device=device).manual_seed)
    hom = nt.make_sim_batch(gen(314), B_MAIN, torch.float32, device=device)
    het = nt.make_sim_batch_hetero(gen(271), B_MAIN, torch.float32, device=device,
                                   gal_model="bdf")
    hom_mb = nt.make_sim_batch_mb(gen(314), B_MB, torch.float32, device=device)
    het_mb = nt.make_sim_batch_mb(gen(271), B_MB, torch.float32, device=device, hetero=True,
                                  gal_model="bdf")
    runs, fns, mb, mb_args = {}, {}, {}, {}
    for model in COMPOSITE:
        runs[model], fns[model] = run_composite(device, model, hom, het)
        mb[model], mb_args[model] = run_composite_mb(device, model, hom_mb, het_mb)
    del hom_mb, het_mb
    phase_line("22 composite", t0, "B=%d float32, exp sims and bdf-truth sims: %s; mb %dx%d: %s"
               % (B_MAIN, "; ".join(
                   "%s-lm m=%.3e hetero_m=%.3e (|m| < %g) R11=%.4f flagged=%d "
                   "hetero_flagged=%d fracdev mean %.4f and %.4f launches k3=%d k2=%d "
                   "stamps/s=%.1f (range %.4f-%.4f s) nfev (mean, p50, max) (%.3f, %g, %d)"
                   % (m, r["m"], r["het_m"], COMPOSITE[m][1], r["R11"], r["flagged"],
                      r["het_flagged"], *r["fracdev"], r["launches"]["k3"],
                      r["launches"]["k2"], r["stamps_per_s"], *r["sec_range"], *r["nfev"])
                   for m, r in runs.items()), B_MB, len(nt.sims.MB_BAND), "; ".join(
                   "%s-lm m=%.3e hetero_m=%.3e flagged=%d hetero_flagged=%d launches k3mb=%d"
                   % (m, r["m"], r["het_m"], r["flagged"], r["het_flagged"],
                      r["launches"]["k3mb"]) for m, r in mb.items())))

    t1 = time.perf_counter()
    inputs = {model: [capture_k3_inputs(x, device, measure=model + "-lm", lm_bounds=box)[0]
                      for x in (het, hom)] for model, (box, _) in COMPOSITE.items()}
    rows3 = {model: composite_k3_row(model, inputs[model][0]) for model in COMPOSITE}
    k2_in, k2_launches = capture_k2_inputs(fns["bdf"], *hom)
    del hom, het
    gm, v = k2_in[:2]
    if v.shape[1] != 361:
        raise SmokeFailure("bdf-lm's first fast K2 launch has %d pixels a lane, not 361"
                           % v.shape[1])
    k2_row = dict(time_k2("bdf-lm get_loglike n=%d fast [%dx%d]" % (gm.shape[1], *v.shape),
                          *k2_in, fast=True), launches_a_call=k2_launches)
    rows3mb = {model: composite_k3mb_row(model, mb_args[model][0]) for model in COMPOSITE}
    k3 = {model: (rows3[model],) + composite_k3_checks(model, *inputs[model])
          for model in COMPOSITE}
    k3mb = {model: (rows3mb[model],) + composite_k3mb_checks(model, *mb_args[model])
            for model in COMPOSITE}
    print("    %s; %s; K2 %s: %.4f ms, plain %.4f ms, bound %.4f ms (%s), %d launches a call; "
          "%.1f s" % ("; ".join(
              "K3 %s (bdf-truth inputs): %.4f ms, plain %.4f ms (%d lanes), bound %.4f ms (%s), "
              "sum nfev %d, %.4f outside rtol 1e-4, within %.3e pars_err; %s; exp path float32: "
              "%d lanes beyond 0.5 pars_err of the float64 optimum (largest %.3f); float64 "
              "against plain, 256 lanes a path: %s"
              % (row["shape"], row["ms"], row["plain_ms"], row["plain_lanes"], row["bound_ms"],
                 row["bound_by"],
                 row["nfev_sum"], row["split"], row["max_in_err"], attrs_text(row["attrs"]),
                 *f32, "; ".join(f64_text(r) for r in f64))
              for row, f32, f64 in k3.values()),
              "; ".join(
              "K3-mb %s: %.4f ms, plain %.4f ms (%d object-lanes), bound %.4f ms (%s), sum nfev "
              "%d, within %.3e pars_err; %s; registers/local bytes/blocks an SM at nband 1-6: "
              "%s; mb exp path float32: %d lanes beyond 0.5 pars_err (largest %.3f); float64 "
              "against plain: %s"
              % (row["shape"], row["ms"], row["plain_ms"], row["plain_lanes"], row["bound_ms"],
                 row["bound_by"],
                 row["nfev_sum"], row["max_in_err"], attrs_text(row["attrs"]),
                 nband_text(row["nband_attrs"]), *f32, "; ".join(f64_text(r) for r in f64))
              for row, f32, f64 in k3mb.values()),
              k2_row["shape"], k2_row["ms"], k2_row["plain_ms"], k2_row["bound_ms"],
              k2_row["bound_by"], k2_row["launches_a_call"], time.perf_counter() - t1),
          flush=True)

    t1 = time.perf_counter()
    replay_check(inputs["bd"][0], "bd")
    replay_check(mb_args["bdf"][0], "bdf", mb=True)
    cc = {(kind, model): composite_card_cpu(cpu_side, kind, model)
          for model in COMPOSITE for kind in ("flat", "mb")}
    phase_line("22 composite-cpu", t1, "the plain solves' replayed steps bitwise equal to their "
               "eager steps (bd, mb bdf: 64 lanes, 8 iterations); float64 card against CPU, bdf "
               "on phase 21's exp inputs, bd on the bdf-truth sims: %s; total %.1f s" % ("; ".join(
                   "%s %s-lm, %d %s (%s=%d): %s" % (
                       kind, m, n, "stamps" if kind == "flat" else "objects x 3 epochs",
                       "k3" if kind == "flat" else "k3mb", launches, f64_text(r))
                   for (kind, m), (r, launches, n) in cc.items()),
                   time.perf_counter() - t_all))
    if any(launches != 1 for _, launches, _ in cc.values()):
        raise SmokeFailure("card against CPU: the composite calls launched K3 or K3-mb %s "
                           "times" % [x[1] for x in cc.values()])
    return dict(
        k3_rows=[row for row, _, _ in k3.values()],
        k3_launches={"%s-lm" % m: r["launches"]["k3"] for m, r in runs.items()},
        k3mb_rows=[row for row, _, _ in k3mb.values()],
        k3mb_launches={"mb %s-lm" % m: r["launches"]["k3mb"] for m, r in mb.items()},
        k2_row=k2_row,
        k2_launches=dict({"%s-lm" % m: r["launches"]["k2"] for m, r in runs.items()},
                         **{"mb %s-lm" % m: r["launches"]["k2"] for m, r in mb.items()}),
        max_abs_err=max(max(row["max_abs_err"], *(r["max_abs"] for r in f64))
                        for row, _, f64 in k3.values()),
        mb_max_abs_err=max(max(row["max_abs_err"], *(r["max_abs"] for r in f64))
                           for row, _, f64 in k3mb.values()),
    )


# ----------------------------------------------------------------------
# prior-regularized fits (phase 23)

# the prior table's arithmetic per row and evaluation, counted from
# csrc/lm_common.cuh as k3_ops is: the row of its kind (at most 20, a
# transcendental as 1) and its sqrt form (2); then, on every thread, the
# row's square into the cost (2) and its Jacobian row into Jtr (2 npars)
# and the JtJ triangle (npars (npars + 1))
PRIOR_ROW_OPS = 22


def prior_ops(prior, npars):
    """the prior rows' operations per evaluation (0 without a prior)"""
    if prior is None:
        return 0
    return prior.n_prior_pars * (PRIOR_ROW_OPS + 2 + 2 * npars + npars * (npars + 1))


def prior_bytes(prior):
    return 0 if prior is None else prior.n_prior_pars * joint_prior.TABLE_COLS * 8


def prior_text(prior):
    if prior is None:
        return ""
    nlmb = int((prior.table()[:, 0] == tpriors.priors.LMBOUNDS).sum())
    return " + %s (%d rows%s)" % (type(prior).__name__, prior.n_prior_pars,
                                 ", %d of LMBounds" % nlmb if nlmb else "")


def exp_prior():
    """the reference test's PriorSimpleSep (tests/test_batch_pipeline.py:389-397)"""
    return joint_prior.PriorSimpleSep(tpriors.CenPrior(0.0, 0.0, 0.263, 0.263),
                                      tpriors.GPriorBA(0.3), tpriors.FlatPrior(0.01, 10.0),
                                      tpriors.FlatPrior(1e-4, 1e9))


def bdf_prior(nband=1):
    """the production PriorBDFSep of tests/_priors.py:16-32: GPriorBA(0.1),
    CenPrior sigma 0.263, TwoSidedErf(-1, 0.1, 1e3, 1) for T, LogNormal(0.5,
    0.1) for fracdev, TwoSidedErf(-100, 0.1, 1e9, 1) for each band's F"""
    F = tpriors.TwoSidedErf(-100.0, 0.1, 1e9, 1.0)
    return joint_prior.PriorBDFSep(tpriors.CenPrior(0.0, 0.0, 0.263, 0.263),
                                   tpriors.GPriorBA(0.1), tpriors.TwoSidedErf(-1.0, 0.1, 1e3, 1.0),
                                   tpriors.LogNormal(0.5, 0.1), F if nband == 1 else [F] * nband)


# each prior fit: its prior, box and |m| limit (exp: bench.py's gate; bdf:
# the fracdev prior is informative, and the reference recorded no m
# for it)
PRIOR_FITS = {"exp": (exp_prior, BOX, 1e-3),
              "bdf": (bdf_prior, nt.sims.BDF_LM_BOUNDS, 3e-3),
              # the same boxes with LMBounds slots (lmbounds_prior)
              "exp lmbounds": (lambda: lmbounds_prior("exp"), BOX, 1e-3),
              "bdf lmbounds": (lambda nband=1: lmbounds_prior("bdf", nband),
                               nt.sims.BDF_LM_BOUNDS, 3e-3)}
# the float32 solves with the prior against their float64 optimum: lanes
# beyond half a pars_err, at most max(8, 1e-4 of the lanes) (fault 3.4's
# bdf limit), none beyond F32_MAX_ERR; on bdf's exp-truth paths, where
# fracdev sits near its bound against the LogNormal prior, at most
# max(8, 0.5% of the lanes) (measured on an H100: K3-mb 20 of 10,240, up
# to 0.613 pars_err; ROADMAP fault 3.4). The float64 solves against the
# plain versions on 256 lanes a path by phase 13's float64 criterion
# (flags equal, e1/e2/T/flux to rtol 1e-5 and atol 1e-7, nfev within 2),
# at most PRIOR_F64_LIMIT lanes outside it
PRIOR_F32_LIMIT = {"exp": lambda n: max(8, n // 10000),
                   "bdf-truth": lambda n: max(8, n // 10000),
                   "bdf exp": lambda n: max(8, n // 200)}
PRIOR_F64_LIMIT = 2


def capture_solve(fn, *args, mb=False):
    """the inputs of the K3 (or K3-mb) call of fn(*args) but the LMConf,
    the model and the prior, the prior, and fn's result"""
    seen = {}
    name = "lm_solve_mb" if mb else "lm_solve"
    solve = getattr(lm_solve, name)

    def spy(*a, **kw):
        seen["args"], seen["prior"] = a[:9 if mb else 8], a[11 if mb else 10]
        return solve(*a, **kw)

    with mock.patch.object(lm_solve, name, spy):
        res = fn(*args)
    return seen["args"], seen["prior"], res


def run_prior_fit(device, model, hom, het, mb=False, key=None):
    """the model's LM main path with its prior and box (PRIOR_FITS[key],
    key the model by default), through K3 on the flat sims (mb: K3-mb on
    the mb sims, the prior of nband flux slots and the box extended to
    the bands), gated, with its launches and the wall time of the hom
    call. Returns the gate values and the solve inputs and prior of the
    hom and het calls"""
    make, box, limit = PRIOR_FITS[key or model]
    measure = model + "-lm"
    if mb:
        nb = nt.sims.MB_NBAND
        fn = nt.make_metacal_pipeline_mb_fn(MB_CONF, nt.sims.MB_BAND, nb, measure=measure,
                                            lm_prior=make(nb), lm_bounds=mb_box(box, nb),
                                            device=device)
    else:
        fn = nt.make_metacal_pipeline_fn(LM_CONF, measure=measure, lm_prior=make(),
                                         lm_bounds=box, device=device)
    _sync(device)
    reset_launches()
    (hom_args, prior, res), sec, _ = timed_call(functools.partial(capture_solve, fn, mb=mb),
                                                *hom)
    het_args, _, het_res = capture_solve(fn, *het, mb=mb)
    _sync(device)
    launches = read_launches()
    B = B_MB if mb else B_MAIN
    what = "%s%s-lm with its prior%s" % ("mb " if mb else "", model,
                                         " of LMBounds" if key else "")
    g = (mb_gate(res, het_res, B, nshape=len(box[0]) - 1) if mb
         else exp_lm_gate(res, het_res, B, npars=len(box[0])))
    if not (abs(g["m"]) < limit and abs(g["het_m"]) < limit):
        raise SmokeFailure("%s m gate failed: m=%.3e hetero m=%.3e > %g"
                           % (what, g["m"], g["het_m"], limit))
    check_flagged(g, B, what)
    k3, other = ("k3mb", "k3") if mb else ("k3", "k3mb")
    if launches[k3] != 2 or launches["k2"] <= 0 or launches[other] or launches["k1"]:
        raise SmokeFailure("the %s path launched %s" % (what, launches))
    types = nt.batch.GALSHEAR_TYPES
    nfev = numiter_stats(*(r[t]["nfev"] for r in (res, het_res) for t in types))
    out = dict(g, launches=launches, per_s=B / sec, nfev=nfev)
    if model == "bdf":
        out["fracdev"] = [float(torch.cat([r[t]["fracdev"][r[t]["flags"] == 0]
                                           for t in types]).mean()) for r in (res, het_res)]
    return out, (hom_args, het_args), prior


def check_cost_pix(state, args, prior, what, mb=False):
    """the state's cost_pix is its cost without the prior rows: equal
    where every row at its parameters is 0, below it where the rows'
    squares exceed 4 ulp of the cost, never above it"""
    lo, hi = args[1], args[2]
    x = tlm.i2e(state["y"], lo, hi)
    rows = prior.fill_fdiff_device(x.double())
    s = (rows * rows).sum(-1)
    cost, cost_pix = state["cost"].double(), state["cost_pix"].double()
    ok = torch.isfinite(cost) & torch.isfinite(s)
    eps = torch.finfo(state["cost"].dtype).eps
    bad = ok & ((cost_pix > cost) | ((s == 0) & (cost_pix != cost))
                | ((s > 4 * eps * cost) & ~(cost_pix < cost)))
    if bool(bad.any()):
        raise SmokeFailure("%s: cost_pix is not the cost without the prior rows on %d lanes"
                           % (what, int(bad.sum())))
    return int((ok & (s > 4 * eps * cost)).sum())


def prior_f64_lanes(a, b, what, keys):
    """two float64 solves of the same lanes (solve_cols or mb_cols; b the
    plain version's) by phase 13's float64 criterion: flags equal on
    every lane; lanes whose keys differ by more than rtol 1e-5 + atol
    1e-7, or whose nfev by more than 2, at most PRIOR_F64_LIMIT. Returns
    that count and the largest relative difference"""
    if not torch.equal(a["flags"], b["flags"]):
        raise SmokeFailure("%s: flags differ on %d lanes"
                           % (what, int((a["flags"] != b["flags"]).sum())))
    far = (a["nfev"] - b["nfev"]).abs() > 2
    rel = torch.zeros_like(a[keys[0]], dtype=torch.float64)
    for k in keys:
        x, y = a[k].double(), b[k].double()
        err = (x - y).abs()
        far |= ~torch.isfinite(x) | (err > 1e-7 + 1e-5 * y.abs())
        rel = torch.maximum(rel, err / y.abs().clamp_min(1e-300))
    n = int(far.sum())
    if n > PRIOR_F64_LIMIT:
        raise SmokeFailure("%s: %d of %d lanes outside rtol 1e-5 or nfev within 2 (limit %d)"
                           % (what, n, far.numel(), PRIOR_F64_LIMIT))
    return n, float(rel[~far].max()) if bool((~far).any()) else 0.0


def prior_kernel_checks(model, paths, prior, mb=False):
    """K3 (mb: K3-mb) with the prior's rows on each path's float32 solve
    inputs (paths: name -> inputs): against its own float64 solve of
    every lane (beyond_optimum with PRIOR_F32_LIMIT), on the first 256
    lanes in float64 against its plain version (prior_f64_lanes; every
    path's lanes in one solve, plain64), and
    cost_pix in both states (check_cost_pix). Returns, by path, the
    lanes beyond half a pars_err and the largest distance, the float64
    lanes outside and the largest relative difference, and the lanes
    whose prior rows count in the cost"""
    conf = nt.LMConf()
    solve = lm_solve.lm_solve_mb if mb else lm_solve.lm_solve
    plain = lm_solve.lm_solve_mb_plain if mb else lm_solve.lm_solve_plain
    keys = MB_KEYS if mb else ("e1", "e2", "T", "flux")

    def cols(state, a):
        return mb_cols(_epilogue_mb(state, a, conf)) if mb else solve_columns(state, a, conf)

    kernel = "K3-mb" if mb else "K3"
    joint, slices, ref = plain64(paths.values(), model, mb, prior)
    kern = cols(solve(*joint, conf, model, prior), joint)
    ref = cols(ref, joint)
    out = {}
    for (name, args), sl in zip(paths.items(), slices):
        what = "%s (%s) with the prior on the %s path" % (kernel, model, name)
        s32 = solve(*args, conf, model, prior)
        a64 = float64(args)
        s64 = solve(*a64, conf, model, prior)
        limit = "bdf exp" if (model, name) == ("bdf", "exp") else name
        f32 = beyond_optimum(limit, cols(s32, args), cols(s64, a64), keys,
                             what + " in float32", limits=PRIOR_F32_LIMIT)
        nrow = check_cost_pix(s32, args, prior, what) + check_cost_pix(s64, a64, prior, what)
        f64 = prior_f64_lanes(rows(kern, sl), rows(ref, sl),
                              what + " in float64 against its plain version", keys)
        out[name] = (f32, f64, nrow)
    return out


def prior_timed_rows(model, args, prior, mb=False):
    """K3 (mb: K3-mb) on the path's float32 solve inputs with the prior's
    rows against its plain version by phase 13's criterion and timed
    beside its bound, with its registers and local memory; and timed on
    the same inputs without the prior, beside that solve's bound"""
    conf = nt.LMConf()
    if mb:
        row = k3mb_model_row(args, conf, model, prior)
        E, P = args[5].shape[1:]
        row["attrs"] = lm_solve.kernel_attrs_mb(torch.float32, nt.sims.MB_NBAND, E, P, model)
        state = lm_solve.lm_solve_mb(*args, conf, model)
        row["ms_no_prior"] = time_ms(lambda: lm_solve.lm_solve_mb(*args, conf, model),
                                     K3_TIMED)
        row["bound_no_prior"] = k3mb_bound(args, state, model)[0]
    else:
        row = k3_timed_row(args, conf, model, prior, plain_lanes=PLAIN_LANES)
        row["attrs"] = lm_solve.kernel_attrs(torch.float32, args[4].shape[1], model)
        state = lm_solve.lm_solve(*args, conf, model)
        row["ms_no_prior"] = time_ms(lambda: lm_solve.lm_solve(*args, conf, model), K3_TIMED)
        row["bound_no_prior"] = k3_bound(args, state, model)[0]
    row["nfev_sum_no_prior"] = int(state["nfev"].sum())
    # the prior rows' share of an evaluation's operations, at the guess
    p = prior_ops(prior, args[0].shape[1])
    row["prior_ops"] = p
    row["prior_share"] = p / (p + eval_ops(args, model, mb))
    return row


def eval_ops(args, model, mb=False):
    """K3's (mb: K3-mb's) mean operations of one evaluation of a lane
    without the prior rows, at the guess (k3_ops)"""
    if not mb:
        rp = model_rp(args[0], nt.batch._psf_gmix(args[3]), model)
        return float(pixel_ops(rp, args[4], args[5], k3_ops(args[0].shape[1])).double().mean())
    guess, psf, band, v, u = args[0], args[3], args[4], args[5], args[6]
    B, E, P = v.shape
    npars = fit_model.shape_count(model) + 1
    bp = fit_model.epoch_band_pars(model, guess, band).reshape(B * E, npars)
    rp = model_rp(bp, nt.batch._psf_gmix(psf.reshape(B * E, 3)), model)
    per_row = pixel_ops(rp, v.reshape(B * E, P), u.reshape(B * E, P), k3_ops(npars))
    return float(per_row.reshape(B, E).sum(-1).double().mean())


def prior_card_cpu(cpu_side, key, box, prior, mb=False):
    """the prior fit in float64 on the card (K3, mb: K3-mb) against the
    CPU (its plain version, from cpu_side's job key) on the same inputs
    by f64_lanes over the five types' lanes with pars_err: flags equal;
    pars and pars_err within rtol 1e-8 + atol 1e-10 and nfev within 2,
    except on max(4, 1%) of the lanes (ROADMAP fault 3.4: at the fracdev
    prior's near-ties float64 solves by two routes part in nfev, 4 apart
    on an H100), whose pars lie within 1e-3 pars_err; unflagged pars
    inside the box. Returns f64_lanes' numbers, the card call's launches
    and the stamps or objects"""
    inputs, cpu = cpu_side.get(key)
    reset_launches()
    if mb:
        args, band = inputs[:2]
        card = nt.make_metacal_pipeline_mb_fn(MB_CONF, band, nt.sims.MB_NBAND,
                                              measure=inputs[2], lm_bounds=box, lm_prior=prior,
                                              device="cuda")(*args)
    else:
        args = inputs[0]
        card = nt.make_metacal_pipeline_fn(LM_CONF, measure=inputs[1], lm_bounds=box,
                                           lm_prior=prior, device="cuda")(*args)
    _sync("cuda")
    launches = read_launches()["k3mb" if mb else "k3"]
    keys = ("flags", "nfev", "pars_err", "pars")
    a = cat_types(card, keys)
    out = f64_lanes(a, cat_types(cpu, keys), "%s with its prior, card against CPU" % key,
                    ("pars", "pars_err"))
    lo, hi = (torch.tensor(x, dtype=torch.float64) for x in box)
    pars = a["pars"][a["flags"] == 0].cpu()
    if not bool(((pars > lo) & (pars < hi)).all()):
        raise SmokeFailure("%s with its prior: pars outside the box" % key)
    return out, launches, args[0].shape[0]


def submit_prior_cpu(side, hom, truth):
    """phase 23's CPU sides: exp-lm with its prior on the first N_CPU exp
    stamps, bdf-lm with its prior on the first N_CPU bdf-truth stamps and
    the mb bdf-lm on N_CPU_MB objects of distinct bdf-truth epochs"""
    side.submit("23 flat exp", flat_cpu_results, ([a[:N_CPU].double() for a in hom],),
                "exp-lm", BOX, exp_prior())
    side.submit("23 flat bdf", flat_cpu_results, ([a[:N_CPU, 0].double() for a in truth],),
                "bdf-lm", nt.sims.BDF_LM_BOUNDS, bdf_prior())
    nb = nt.sims.MB_NBAND
    side.submit("23 mb bdf", mb_cpu_results, distinct_epochs(truth, N_CPU_MB), "bdf-lm",
                mb_box(nt.sims.BDF_LM_BOUNDS, nb), bdf_prior(nb))


def prior_phase(device, t_all, cpu_side):
    """phase 23: exp-lm (the reference test's prior and box) and bdf-lm
    (the production PriorBDFSep and box) through K3, and the mb bdf-lm
    through K3-mb, with their priors, gated; K3 and K3-mb with the prior
    rows against their float64 optimum and plain versions
    (prior_kernel_checks) and timed with and without the prior
    (prior_timed_rows); card against CPU in float64 (prior_card_cpu).
    Returns K3's and K3-mb's rows, launches by path and largest
    absolute errors, and K2's launches"""
    t0 = time.perf_counter()
    gen = functools.partial(torch.Generator(device=device).manual_seed)
    hom = nt.make_sim_batch(gen(314), B_MAIN, torch.float32, device=device)
    truth = nt.make_sim_batch_hetero(gen(271), B_MAIN, torch.float32, device=device,
                                     gal_model="bdf")
    hom_mb = nt.make_sim_batch_mb(gen(314), B_MB, torch.float32, device=device)
    truth_mb = nt.make_sim_batch_mb(gen(271), B_MB, torch.float32, device=device,
                                    hetero=True, gal_model="bdf")
    het = nt.make_sim_batch_hetero(gen(271), B_MAIN, torch.float32, device=device)
    exp_run, exp_args, eprior = run_prior_fit(device, "exp", hom, het)
    bdf_run, bdf_args, bprior = run_prior_fit(device, "bdf", hom, truth)
    mb_run, mb_args, mprior = run_prior_fit(device, "bdf", hom_mb, truth_mb, mb=True)
    # phase 29's LMBounds through K3 and K3-mb, on the same sims
    lexp_run, lexp_args, lprior = run_prior_fit(device, "exp", hom, het, key="exp lmbounds")
    lmb_run, lmb_args, lmprior = run_prior_fit(device, "bdf", hom_mb, truth_mb, mb=True,
                                               key="bdf lmbounds")
    del hom, het, truth, hom_mb, truth_mb
    t_fits = time.perf_counter()
    checks = {
        "exp": prior_kernel_checks("exp", {"exp": exp_args[0]}, eprior),
        "bdf": prior_kernel_checks("bdf", {"exp": bdf_args[0], "bdf-truth": bdf_args[1]},
                                   bprior),
        "mb bdf": prior_kernel_checks("bdf", {"exp": mb_args[0], "bdf-truth": mb_args[1]},
                                      mprior, mb=True),
        "exp lmbounds": prior_kernel_checks("exp", {"exp": lexp_args[0]}, lprior),
        "mb bdf lmbounds": prior_kernel_checks("bdf", {"bdf-truth": lmb_args[1]}, lmprior,
                                               mb=True),
    }
    t_checks = time.perf_counter()
    rows = {"exp": prior_timed_rows("exp", exp_args[0], eprior),
            "bdf": prior_timed_rows("bdf", bdf_args[1], bprior),
            "mb bdf": prior_timed_rows("bdf", mb_args[1], mprior, mb=True),
            "exp lmbounds": prior_timed_rows("exp", lexp_args[0], lprior),
            "mb bdf lmbounds": prior_timed_rows("bdf", lmb_args[1], lmprior, mb=True)}
    t_rows = time.perf_counter()
    cc = {"flat exp": prior_card_cpu(cpu_side, "23 flat exp", BOX, eprior),
          "flat bdf": prior_card_cpu(cpu_side, "23 flat bdf", nt.sims.BDF_LM_BOUNDS, bprior),
          "mb bdf": prior_card_cpu(cpu_side, "23 mb bdf",
                                   mb_box(nt.sims.BDF_LM_BOUNDS, nt.sims.MB_NBAND), mprior,
                                   mb=True)}
    if any(x[1] != 1 for x in cc.values()):
        raise SmokeFailure("card against CPU: the prior calls launched K3 or K3-mb %s times"
                           % [x[1] for x in cc.values()])
    t_cc = time.perf_counter()
    runs = {"exp-lm": exp_run, "bdf-lm": bdf_run, "mb bdf-lm": mb_run,
            "exp-lm lmbounds": lexp_run, "mb bdf-lm lmbounds": lmb_run}
    phase_line("23 priors", t0, "B=%d float32 (mb %dx%d), exp sims and %s: %s; %s; card "
               "against CPU float64: %s; total %.1f s" % (
                   B_MAIN, B_MB, len(nt.sims.MB_BAND), "het sims (exp) / bdf-truth sims", "; ".join(
                       "%s m=%.3e hetero_m=%.3e R11=%.4f flagged=%d hetero_flagged=%d%s "
                       "launches k3=%d k3mb=%d k2=%d %s/s=%.1f (one call) nfev (%.3f, %g, %d)"
                       % (k, r["m"], r["het_m"], r["R11"], r["flagged"], r["het_flagged"],
                          " fracdev %.4f and %.4f" % tuple(r["fracdev"]) if "fracdev" in r
                          else "", r["launches"]["k3"], r["launches"]["k3mb"],
                          r["launches"]["k2"], "objects" if k.startswith("mb") else "stamps",
                          r["per_s"], *r["nfev"]) for k, r in runs.items()),
                   "; ".join("%s %s: float32 %d lanes beyond 0.5 pars_err of float64 (max "
                             "%.3f), float64 256 lanes %d outside rtol 1e-5 (max rel %.2e), "
                             "%d lanes' rows in the cost" % (k, p, *f32, *f64, nrow)
                             for k, c in checks.items() for p, (f32, f64, nrow) in c.items()),
                   "; ".join("%s %d: %s" % (k, n, f64_text(r)) for k, (r, _, n) in cc.items()),
                   time.perf_counter() - t_all))
    print("    %s" % "; ".join(
        "%s %s: %.4f ms (no prior %.4f), plain %.4f ms (%d lanes), bound %.4f ms (%s; no prior "
        "%.4f), sum nfev %d (no prior %d), within %.3e pars_err of plain, %s, prior %d "
        "operations an evaluation (%.3f%%)"
        % (("K3-mb" if k.startswith("mb") else "K3"), r["shape"], r["ms"], r["ms_no_prior"],
           r["plain_ms"], r["plain_lanes"], r["bound_ms"], r["bound_by"], r["bound_no_prior"],
           r["nfev_sum"],
           r["nfev_sum_no_prior"], r["max_in_err"], attrs_text(r["attrs"]),
           r["prior_ops"], 100 * r["prior_share"]) for k, r in rows.items())
        + "; fits %.1f s, checks %.1f s, timed rows %.1f s, card against CPU %.1f s"
        % (t_fits - t0, t_checks - t_fits, t_rows - t_checks, t_cc - t_rows), flush=True)
    return dict(
        k3_rows=[rows["exp"], rows["bdf"], rows["exp lmbounds"]],
        k3_launches={"%s prior" % k: r["launches"]["k3"] for k, r in runs.items()
                     if not k.startswith("mb")},
        k3mb_rows=[rows["mb bdf"], rows["mb bdf lmbounds"]],
        k3mb_launches={"%s prior" % k: r["launches"]["k3mb"] for k, r in runs.items()
                       if k.startswith("mb")},
        k2_launches={"%s prior" % k: r["launches"]["k2"] for k, r in runs.items()},
        max_abs_err=max(rows[k]["max_abs_err"] for k in ("exp", "bdf", "exp lmbounds")),
        mb_max_abs_err=max(rows[k]["max_abs_err"] for k in ("mb bdf", "mb bdf lmbounds")),
    )


# ----------------------------------------------------------------------
# the LM options (phase 24) and scale-out (phase 25)

# the option calls of phase 24: name -> (measure, box, MetacalConfig,
# LMConf): exp-lm with variable projection, exp-lm with the sheared types
# refined by 3 Gauss-Newton steps, and bdf-lm in its production box
# (fracdev on its bound on the exp sims, the reference test's case) the
# same
OPTION_RUNS = {
    "exp-lm varpro": ("exp-lm", None, LM_CONF, tlm.LMConf(varpro=True)),
    "exp-lm refine": ("exp-lm", None, LM_CONF._replace(sheared_refine=3), None),
    "bdf-lm refine": ("bdf-lm", nt.sims.BDF_LM_BOUNDS, LM_CONF._replace(sheared_refine=3), None),
}
# the value pass of K3's varpro mode (csrc/lm_common.cuh: value_pass),
# counted as K1_OPS: per (pixel, gaussian) the offsets and chi2 (11); per
# pair inside the window the exponential and its argument, the windowed
# value and its sum (5); per pair in the apodized band the window (8);
# per pixel the weighted model and the two sums (5)
VALUE_OPS = (11, 5, 8, 5)
# the float32 modes against their plain versions on the same lanes: the
# lanes beyond half a pars_err, none on exp; on bdf, whose fracdev sits
# on its bound on the exp sims, fault 3.4's bdf limit (F32_LIMIT)
OPTION_F32_LIMIT = {"exp": lambda n: 0, "bdf": F32_LIMIT["bdf"]}


def option_cpu_results(args, measure, box, conf, lm_conf):
    """an option call's float64 results on the CPU (the plain versions)"""
    return nt.make_metacal_pipeline_fn(conf, measure=measure, lm_bounds=box, lm_conf=lm_conf,
                                       device="cpu")(*(a.cpu() for a in args))


def capture_option_solve(fn, *args):
    """the arguments but the LMConf, model and prior, and the keywords
    (the mode), of the last K3 call of fn(*args)"""
    seen = {}
    solve = lm_solve.lm_solve

    def spy(*a, **kw):
        seen["call"] = (a[:8], kw)
        return solve(*a, **kw)

    with mock.patch.object(lm_solve, "lm_solve", spy):
        fn(*args)
    return seen["call"]


def option_result(state, args, conf, model, varpro):
    """the LM result of a K3 options state on K3's inputs args"""
    nres = torch.sum(args[6] > 0, dim=-1)
    if varpro:
        return nt.batch.varpro_result(state, args[1], args[2], conf, nres,
                                      nt.batch._MODEL_NSHAPE[model])
    return tlm._normal_epilogue(state, args[1], args[2], conf, nres)


def option_bound(args, state, model, varpro):
    """least time (ms) of an options launch on these inputs: the planes,
    guess, bounds and psf read once and the state (and varpro's
    full-width evaluation) written once, or the operations: refine's
    niter + 1 evaluations a lane (k3_ops), varpro's nfev + 1 evaluations
    of a value pass (VALUE_OPS) and K1's pass (k3_ops) each"""
    if not varpro:
        return k3_bound(args, state, model)
    guess, lo, hi, psf, v, u, ia, ve = args
    rp = model_rp(guess, nt.batch._psf_gmix(psf), model)
    per_eval = pixel_ops(rp, v, u, k3_ops(guess.shape[1])) + pixel_ops(rp, v, u, VALUE_OPS)
    ops = int((per_eval * (state["nfev"].long() + 1)).sum())
    N, P = v.shape
    out = [x for k, x in state.items() if k != "full"] + list(state["full"].values())
    nbytes = (v.element_size() * (4 * N * P + guess.numel() + 12 + psf.numel())
              + sum(x.numel() * x.element_size() for x in out))
    return least_ms(nbytes, ops, v.dtype)


def option_kernel_row(name, args, kw, conf, model):
    """K3's mode (kw: refine or varpro) on an option call's captured
    float32 solve inputs: on the first 256 lanes in float64 against its
    plain version (flags equal, e1/e2/T/flux to rtol 1e-5 and atol 1e-7,
    nfev within 2); in float32 at the full shape, on the first
    PLAIN_LANES lanes against its plain version there, timed in that
    call (flags equal on every lane, and unflagged e1/e2/T/flux within
    half the lane's pars_err but on OPTION_F32_LIMIT lanes); then timed
    at the full shape beside its bound"""
    varpro = bool(kw.get("varpro"))
    a64 = first_lanes(args)
    card = option_result(lm_solve.lm_solve(*a64, conf, model, None, **kw), a64, conf, model,
                         varpro)
    plain = option_result(lm_solve.lm_solve_plain(*a64, conf, model, None, **kw), a64, conf,
                          model, varpro)
    max_abs, max_rel, dnfev = per_lane_diff(solve_cols(card), solve_cols(plain),
                                            "K3 %s float64 against its plain version" % name)
    state = lm_solve.lm_solve(*args, conf, model, None, **kw)
    pa = lanes(args, PLAIN_LANES)
    plain, _, plain_ms = timed_call(lambda: lm_solve.lm_solve_plain(*pa, conf, model, None,
                                                                    **kw))
    n = len(pa[0])
    f32 = {k: v[:n] for k, v in solve_cols(option_result(state, args, conf, model,
                                                         varpro)).items()}
    f32_far, f32_worst = beyond_optimum(
        model, f32, solve_cols(option_result(plain, pa, conf, model, varpro)),
        ("e1", "e2", "T", "flux"), "K3 %s in float32 against its plain version" % name,
        limits=OPTION_F32_LIMIT, ref="its plain version")
    ms = time_ms(lambda: lm_solve.lm_solve(*args, conf, model, None, **kw), K3_TIMED)
    b_ms, by = option_bound(args, state, model, varpro)
    nfev = state["nfev"]
    return dict(shape="%s %s NG=%d [%dx%d]" % (model, "varpro" if varpro else
                                               "refine=%d" % kw["refine"], NGAUSS[model],
                                               *args[4].shape),
                ms=ms, plain_ms=plain_ms, plain_lanes=len(pa[0]), bound_ms=b_ms, bound_by=by,
                max_abs_err=max_abs, max_rel_err=max_rel, dnfev=dnfev, nfev_sum=int(nfev.sum()),
                f32_lanes=n, f32_far=f32_far, f32_worst=f32_worst,
                attrs=lm_solve.kernel_attrs_opt(torch.float32, args[4].shape[1], model))


def options_phase(device, t_all, cpu_side):
    """phase 24: the LM options at B = 10240 in float32 on the exp sims,
    each gated like phase 8 against the full-LM call's g1 and time;
    flux_col bitwise equal to the default; K3's refine and varpro modes
    against their plain versions and timed (option_kernel_row); the
    option pipelines card against CPU in float64. Returns the modes'
    rows and launches by path, K3's launches by path and K2's"""
    t0 = time.perf_counter()
    gen = functools.partial(torch.Generator(device=device).manual_seed)
    hom = nt.make_sim_batch(gen(314), B_MAIN, torch.float32, device=device)
    het = nt.make_sim_batch_hetero(gen(271), B_MAIN, torch.float32, device=device)
    base = {}
    for measure, box in (("exp-lm", None), ("bdf-lm", nt.sims.BDF_LM_BOUNDS)):
        fn = nt.make_metacal_pipeline_fn(LM_CONF, measure=measure, lm_bounds=box,
                                         device=device)
        base[measure] = (fn(*hom), timed3(fn, *hom)[0])
    flux_col = nt.make_metacal_pipeline_fn(LM_CONF, measure="exp-lm",
                                           lm_conf=tlm.LMConf(flux_col=True), device=device)(*hom)
    for t in nt.batch.GALSHEAR_TYPES:
        for k, v in base["exp-lm"][0][t].items():
            if not torch.equal(flux_col[t][k], v):
                raise SmokeFailure("exp-lm with flux_col=True differs from the default in "
                                   "%s %s" % (t, k))
    runs, solves = {}, {}
    for name, (measure, box, conf, lm_conf) in OPTION_RUNS.items():
        fn = nt.make_metacal_pipeline_fn(conf, measure=measure, lm_bounds=box, lm_conf=lm_conf,
                                         device=device)
        _sync(device)
        reset_launches()
        res = fn(*hom)
        het_res = fn(*het)
        _sync(device)
        launches = read_launches()
        g = exp_lm_gate(res, het_res, B_MAIN, npars=6 if box is None else len(box[0]))
        check_gate(g, B_MAIN, name)
        want = dict(k3=0, k3v=2, k3r=0) if "varpro" in name else dict(k3=2, k3v=0, k3r=2)
        if any(launches[k] != n for k, n in want.items()) or launches["k2"] <= 0:
            raise SmokeFailure("%s launched %s in two calls, not %s and K2" % (
                name, {k: launches[k] for k in want}, want))
        ref = base[measure][0]
        dg1 = max(float((res[t]["e1"] - ref[t]["e1"])[(res[t]["flags"] == 0)
                                                       & (ref[t]["flags"] == 0)].abs().max())
                  for t in nt.batch.GALSHEAR_TYPES)
        nfev = numiter_stats(*(r[t]["nfev"] for r in (res, het_res)
                               for t in nt.batch.GALSHEAR_TYPES))
        runs[name] = dict(g, launches=launches, dg1=dg1, sec=timed3(fn, *hom)[0], nfev=nfev)
        solves[name] = capture_option_solve(fn, *hom)
    del het
    t_runs = time.perf_counter()
    rows = {name: option_kernel_row(name, args, kw, tlm.LMConf(), OPTION_RUNS[name][0][:-3])
            for name, (args, kw) in solves.items()}
    t_rows = time.perf_counter()
    cc = {}
    for name, (measure, box, conf, lm_conf) in OPTION_RUNS.items():
        (args, *_), cpu = cpu_side.get("24 " + name)
        card = nt.make_metacal_pipeline_fn(conf, measure=measure, lm_bounds=box,
                                           lm_conf=lm_conf, device="cuda")(*args)
        keys = ("flags", "nfev", "pars_err", "pars", "s2n")
        cc[name] = f64_lanes(cat_types(card, keys), cat_types(cpu, keys),
                             "%s card against CPU" % name, ("pars", "s2n"))
    phase_line("24 options", t0, "B=%d float32, exp sims: %s; exp-lm flux_col=True bitwise "
               "the default; full LM exp-lm %.4f s a call, bdf-lm %.4f s; K3 modes against "
               "plain (float64 on 256 lanes): %s; card against CPU float64, 256 stamps: %s; "
               "calls %.1f s, kernel rows %.1f s, card against CPU %.1f s; phases 5-24 "
               "waited %.1f s for the CPU sides, %d jobs of %s CPU; total %.1f s" % (
                   B_MAIN, "; ".join(
                       "%s m=%.3e hetero_m=%.3e flagged=%d hetero_flagged=%d launches k3=%d "
                       "k3r=%d k3v=%d |dg1| from the full LM %.3e, %.4f s a call (median of "
                       "3), nfev (%.3f, %g, %d)"
                       % (k, r["m"], r["het_m"], r["flagged"], r["het_flagged"],
                          r["launches"]["k3"], r["launches"]["k3r"], r["launches"]["k3v"],
                          r["dg1"], r["sec"], *r["nfev"]) for k, r in runs.items()),
                   base["exp-lm"][1], base["bdf-lm"][1],
                   "; ".join("%s max rel %.2e nfev diff %d, float32 %d lanes %d beyond 0.5 "
                             "pars_err (max %.3f)" % (k, r["max_rel_err"], r["dnfev"],
                                                      r["f32_lanes"], r["f32_far"],
                                                      r["f32_worst"])
                             for k, r in rows.items()),
                   "; ".join("%s %s" % (k, f64_text(r)) for k, r in cc.items()),
                   t_runs - t0, t_rows - t_runs, time.perf_counter() - t_rows,
                   cpu_side.waited, len(cpu_side.cpu), cpu_side.cpu_text(),
                   time.perf_counter() - t_all))
    print("    %s" % "; ".join(
        "K3 %s: %.4f ms, plain %.4f ms (%d lanes), bound %.4f ms (%s), sum nfev %d, %s"
        % (r["shape"], r["ms"], r["plain_ms"], r["plain_lanes"], r["bound_ms"], r["bound_by"],
           r["nfev_sum"], attrs_text(r["attrs"])) for r in rows.values()), flush=True)
    return dict(
        refine_rows=[r for k, r in rows.items() if "refine" in k],
        varpro_rows=[r for k, r in rows.items() if "varpro" in k],
        refine_launches={k: r["launches"]["k3r"] for k, r in runs.items() if "refine" in k},
        varpro_launches={k: r["launches"]["k3v"] for k, r in runs.items() if "varpro" in k},
        k3_launches={k: r["launches"]["k3"] for k, r in runs.items() if r["launches"]["k3"]},
        k2_launches={k: r["launches"]["k2"] for k, r in runs.items()},
        refine_max_abs_err=max(max(r["max_abs_err"], cc[k]["max_abs"])
                               for k, r in rows.items() if "refine" in k),
        varpro_max_abs_err=max(max(r["max_abs_err"], cc[k]["max_abs"])
                               for k, r in rows.items() if "varpro" in k),
    )


def ragged_catalog(hom, n):
    """a catalog of 2 n objects from the sims' stamps as numpy: n
    single-epoch 49x49 stamps (the flat bucket), n / 2 objects of two
    epochs and n / 2 of one as 41x41 central crops (the mb bucket, with a
    pad epoch)"""
    ims, wts, cens, pims, pcens, noise = (x.cpu().numpy() for x in hom)
    crop = slice(4, nt.sims.DIMS[0] - 4)

    def obj(idx, c=slice(None), off=0.0):
        return dict(image=[ims[i][c, c] for i in idx], weight=[wts[i][c, c] for i in idx],
                    cen=cens[idx] - off, psf_image=[pims[i] for i in idx], psf_cen=pcens[idx],
                    noise=[noise[i][c, c] for i in idx])

    cat = [obj([i]) for i in range(n)]
    cat += [obj([n + i, 2 * n + i] if i % 2 == 0 else [n + i], crop, 4.0) for i in range(n)]
    return cat


def free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def scaleout_phase(device, t_all, n=512):
    """phase 25: metacal_pipeline_ragged (exp-lm, float32) on a catalog of
    two stamp sizes with single- and multi-epoch objects, each bucket's
    rows equal to a direct call of its pipeline; a checkpoint written in
    two shards, resumed and read back; and a one-process NCCL group: the
    sharded flat and mb pipelines' rows and calibration equal to the
    unsharded calls'"""
    import tempfile

    from ngmix_tpu_torch import checkpoint, ragged
    from ngmix_tpu_torch.parallel import distributed, mesh

    t0 = time.perf_counter()
    gen = functools.partial(torch.Generator(device=device).manual_seed)
    hom = nt.make_sim_batch(gen(17), 3 * n, torch.float32, device=device)
    cat = ragged_catalog(hom, n)
    conf = LM_CONF._replace(dims=(0, 0))
    res = ragged.metacal_pipeline_ragged(cat, conf, measure="exp-lm", dtype=torch.float32,
                                         device=device)
    keys = ("images", "weights", "cens", "psf_images", "psf_cens", "noises")
    buckets = ragged.pack_ragged(cat)
    for b in buckets:
        conf_b = conf._replace(dims=b["dims"], psf_dims=b["psf_dims"])
        arrays = [torch.as_tensor(b[k], dtype=torch.float32) for k in keys]
        if b["nepoch"] == 1:
            direct = nt.metacal_pipeline(*(a[:, 0] for a in arrays), conf_b, measure="exp-lm",
                                         device=device)
        else:
            direct = nt.metacal_pipeline_mb(*arrays, b["band"], 1, conf_b, measure="exp-lm",
                                            device=device)
        for t in nt.batch.GALSHEAR_TYPES:
            for k, v in direct[t].items():
                if not np.array_equal(res[t][k][b["indices"]], v.cpu().numpy()):
                    raise SmokeFailure("ragged: %s %s of the %s bucket differs from the direct "
                                       "call" % (t, k, b["dims"]))
    flagged = int((res["noshear"]["flags"] != 0).sum())
    with tempfile.TemporaryDirectory() as tmp:
        half = len(cat) // 2
        rows = {t: res[t] for t in nt.batch.GALSHEAR_TYPES}
        w = checkpoint.ResultWriter(tmp)
        w.write(0, {t: {k: v[:half] for k, v in r.items()} for t, r in rows.items()})
        resume = checkpoint.ResultWriter(tmp).next_index()
        checkpoint.ResultWriter(tmp).write(1, {t: {k: v[half:] for k, v in r.items()}
                                               for t, r in rows.items()})
        back = checkpoint.load_results(tmp)
        if resume != 1 or checkpoint.ResultWriter(tmp).next_index() != 2 or any(
                not np.array_equal(back["%s/%s" % (t, k)], v)
                for t, r in rows.items() for k, v in r.items()):
            raise SmokeFailure("checkpoint round trip failed (resume index %d)" % resume)
    distributed.initialize(init_method="tcp://localhost:%d" % free_port(), world_size=1,
                           rank=0)
    try:
        backend = torch.distributed.get_backend()
        args = [a[:n] for a in hom]
        sharded, calib = mesh.make_sharded_pipeline_fn(LM_CONF, measure="exp-lm")(
            *distributed.global_batch_from_local(*args))
        direct = nt.make_metacal_pipeline_fn(LM_CONF, measure="exp-lm", device=device)(*args)
        mb_args = nt.make_sim_batch_mb(gen(18), n // 4, torch.float32, device=device)
        mb_sharded, mb_calib = mesh.make_sharded_mb_pipeline_fn(
            MB_CONF, nt.sims.MB_BAND, nt.sims.MB_NBAND)(*mb_args)
        mb_direct = nt.make_metacal_pipeline_mb_fn(MB_CONF, nt.sims.MB_BAND, nt.sims.MB_NBAND,
                                                   device=device)(*mb_args)
        for what, a, b in (("flat", sharded, direct), ("mb", mb_sharded, mb_direct),
                           ("calibration", {"c": calib}, {"c": nt.shear_response(direct)}),
                           ("mb calibration", {"c": mb_calib},
                            {"c": nt.shear_response(mb_direct)})):
            for t, r in b.items():
                if not isinstance(r, dict):
                    continue
                for k, v in r.items():
                    if not torch.equal(a[t][k], v):
                        raise SmokeFailure("sharded %s: %s %s differs from the unsharded call"
                                           % (what, t, k))
    finally:
        torch.distributed.destroy_process_group()
    phase_line("25 scale-out", t0, "ragged exp-lm float32, %d objects in buckets %s: rows equal "
               "to each bucket's direct call, flagged=%d; checkpoint of 2 shards resumed at 1 "
               "and read back equal; one-process %s group: sharded flat (%d stamps) and mb (%d "
               "objects) rows and calibration equal to the unsharded calls' (m=%.3e)" % (
                   len(cat), ["%dx%d, E=%d, %d objects" % (*b["dims"], b["nepoch"],
                                                          len(b["indices"])) for b in buckets],
                   flagged, backend, n, n // 4, m_of(calib)) + "; total %.1f s"
               % (time.perf_counter() - t_all))



# ----------------------------------------------------------------------
# the host single-object API

# objects a host fitter takes in phase 26, and the seed of its sims
HOST_N = {"admom": 64, "gaussmom": 64, "prepsf": 16, "em": 8}
HOST_SEED = 26
# the exp mixture (n = 6) that GMix.make_image renders, card and CPU
HOST_RENDER_PARS = (0.1, -0.05, 0.2, -0.1, 0.5, 100.0)
# the host fitters against their batched counterparts: rtol 1e-10 and
# gaussmom's atol (tests/test_torch_gaussmom.py), pre-psf's
# (tests/test_prepsfmom.py:226)
HOST_RTOL, HOST_ATOL = 1e-10, 1e-12
PREPSF_RTOL, PREPSF_ATOL = 1e-10, 1e-13


def host_render(pars, device):
    """GMix.make_image of the exp mixture of pars on a 49x49 stamp under
    the sims' WCS, exact and fast, on device"""
    gm = nt.GMixModel(list(pars), "exp")
    jac = nt.DiagonalJacobian(row=24.3, col=23.8, scale=nt.sims.SCALE)
    return [gm.make_image(nt.sims.DIMS, jacobian=jac, fast_exp=fast, device=device)
            for fast in (False, True)]


def host_observations(sims, n, device):
    """the first n sim stamps as Observations on device, each with its
    psf stamp as its psf Observation, under the sims' WCS centered on
    the stamp's center"""
    imgs, wts, cens, pimgs, pcens, _ = (a[:n].cpu().numpy() for a in sims)

    def jac(c):
        return nt.DiagonalJacobian(row=c[0], col=c[1], scale=nt.sims.SCALE)

    return [nt.Observation(imgs[i], weight=wts[i], jacobian=jac(cens[i]), device=device,
                           psf=nt.Observation(pimgs[i], jacobian=jac(pcens[i]), device=device))
            for i in range(n)]


def stacked_pixels(obs):
    """the observations' pixel structs stacked into one [n, P] struct"""
    return nt.pixels.Pixels(*(torch.stack([o.pixels[k] for o in obs]) for k in range(5)))


def hold_rows(host, batch, what, rtol=HOST_RTOL, atol=HOST_ATOL):
    """each host result (a dict of numbers and arrays) against its row
    of the batched result (a dict of tensors): integer fields equal,
    the others within rtol and atol with NaNs in the same places.
    Returns the largest share of the tolerance a difference takes"""
    worst = 0.0
    for k, col in batch.items():
        if k not in host[0]:
            continue
        b = col.detach().cpu().double().reshape(len(host), -1)
        a = torch.stack([torch.as_tensor(np.asarray(h[k], dtype=np.float64)).reshape(-1)
                         for h in host])
        if not col.is_floating_point():
            if not torch.equal(a, b):
                raise SmokeFailure("%s: %s differs from the batched call" % (what, k))
            continue
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise SmokeFailure("%s: the NaNs of %s differ from the batched call" % (what, k))
        a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        tol = rtol * b.abs() + atol
        err = (a - b).abs()
        if bool((err > tol).any()):
            raise SmokeFailure("%s: %s differs from the batched call by %.3e"
                               % (what, k, float(err.max())))
        worst = max(worst, float((err / tol).max()))
    return worst


def host_phase(device, t_all, cpu_side):
    """phase 26: the single-object host API on the card in float64 on
    the sims' 49x49 stamps, each fitter held object by object to its
    batched counterpart on the same stamps and guesses; GMix.make_image
    against its CPU render (the CPU side from cpu_side); K2 at the host
    shapes"""
    t0 = time.perf_counter()
    dtype = torch.float64
    sims = nt.make_sim_batch(torch.Generator(device=device).manual_seed(HOST_SEED),
                             max(HOST_N.values()), dtype, device=device)
    obs = host_observations(sims, max(HOST_N.values()), device)
    scale = nt.sims.SCALE
    rng = np.random.RandomState(HOST_SEED)
    guesses = [nt.GMixModel([*rng.uniform(-scale / 2, scale / 2, 2), *rng.uniform(-0.3, 0.3, 2),
                             0.6 * (1 + rng.uniform(-0.1, 0.1)), 1.0], "gauss")
               for _ in range(HOST_N["admom"])]
    em_guess = nt.GMixModel([0.0, 0.0, 0.0, 0.0, 0.6, 1.0], "gauss")
    prepsf = {"pgauss": nt.PGaussMom(PREPSF_FWHM), "ksigma": nt.KSigmaMom(PREPSF_FWHM)}

    # the host API's run: K2's launches counted from 0, each fitter timed
    host, ms, k2 = {}, {}, {}

    def run(name, n, fn):
        _sync(device)
        gmix_eval.launches = 0
        t = time.perf_counter()
        host[name] = [fn(i) for i in range(n)]
        _sync(device)
        ms[name] = (time.perf_counter() - t) * 1e3 / n
        k2[name] = gmix_eval.launches

    fitter = nt.admom.AdmomFitter()
    run("admom", HOST_N["admom"], lambda i: fitter.go(obs[i], guesses[i]))
    gmom = nt.GaussMom(1.2)
    run("gaussmom", HOST_N["gaussmom"], lambda i: gmom.go(obs[i]))
    for name, m in prepsf.items():
        run(name, HOST_N["prepsf"], lambda i: m.go(obs[i]))
    em = nt.EMFitter()
    run("em", HOST_N["em"], lambda i: em.go(obs[i], em_guess))
    run("make_image", 1, lambda i: host_render(HOST_RENDER_PARS, device))
    want = {"admom": sum(2 * r["numiter"] + 1 for r in host["admom"]),
            "gaussmom": HOST_N["gaussmom"], "pgauss": 0, "ksigma": 0, "em": 0, "make_image": 2}
    if k2 != want:
        raise SmokeFailure("host API: K2 launches %s, expected %s" % (k2, want))

    # the batched counterparts on the same stamps and guesses
    n = HOST_N["admom"]
    area = torch.full((n,), scale**2, dtype=dtype, device=device)
    wt0 = torch.tensor(np.stack([g.get_data()[0] for g in guesses]), device=device)
    shares = {"admom": hold_rows(host["admom"], nt.admom_batch(
        stacked_pixels(obs[:n]), wt0, area, nt.AdmomConf(), device=device), "AdmomFitter")}
    n = HOST_N["gaussmom"]
    shares["gaussmom"] = hold_rows(host["gaussmom"], nt.gaussmom.gaussmom_measure(
        stacked_pixels(obs[:n]), 1.2, area[:n]), "GaussMom")
    n = HOST_N["prepsf"]
    imgs, wts, cens, pimgs, pcens, _ = (a[:n] for a in sims)
    tot_var = torch.tensor([float(np.sum(1.0 / o.weight[o.weight > 0])) for o in obs[:n]],
                           dtype=dtype, device=device)
    for name in prepsf:
        shares[name] = hold_rows(host[name], nt.prepsfmom_batch(
            imgs, cens, pimgs, pcens, tot_var, target_dim=4 * nt.sims.DIMS[0], kernel=name,
            jac_tuple=nt.sims.JAC, fwhm=PREPSF_FWHM, device=device), "PrePSFMom " + name,
            rtol=PREPSF_RTOL, atol=PREPSF_ATOL)
    n = HOST_N["em"]
    preps = [nt.em.prep_obs(o) for o in obs[:n]]
    batch = nt.em_batch(stacked_pixels([p[0] for p in preps]),
                        torch.tensor(np.stack([em_guess.get_data()] * n), device=device),
                        torch.tensor([[[1.0, 0, 0, 0, 0, 0]]] * n, dtype=dtype, device=device),
                        torch.tensor([p[1] for p in preps], dtype=dtype, device=device),
                        nt.EMConf(), device=device)
    em_rows = [dict(r, gmix=r.get_gmix().get_data(),
                    gmix_conv=r.get_convolved_gmix().get_data()) for r in host["em"]]
    shares["em"] = hold_rows(em_rows, {k: batch[k] for k in ("flags", "numiter", "gmix",
                                                             "gmix_conv", "sky", "fdiff")},
                             "EMFitter")

    # GMix.make_image on the card against its CPU render
    _, cpu_imgs = cpu_side.get("26 render")
    card_imgs = host["make_image"][0]
    render_err = 0.0
    for mode, a, b in zip(("exact", "fast"), card_imgs, cpu_imgs):
        err = np.abs(a - b)
        tol = 1e-12 * np.abs(b) + 1e-12 * np.abs(b).max()
        if not np.all(err <= tol):
            raise SmokeFailure("GMix.make_image %s: the card's render differs from the CPU's "
                               "by %.3e" % (mode, err.max()))
        render_err = max(render_err, float((err / np.abs(b).max()).max()))

    # K2 at the host shapes: one lane of 2401 pixels, admom's weight
    # (n = 1, fast) and the render (n = 6, exact)
    px = obs[0].pixels
    v, u, a1 = (x[None].contiguous() for x in (px.v, px.u, px.area))
    wt = torch.as_tensor(guesses[0].get_data(), device=device)[None]
    gm6 = nt.GMixModel(list(HOST_RENDER_PARS), "exp").to_device(device)[None]
    rows = [dict(time_k2("host admom weight n=1 [1x2401]", wt, v, u, a1, True),
                 launches_a_object=want["admom"] / HOST_N["admom"]),
            dict(time_k2("host make_image n=6 [1x2401]", gm6, v, u, scale**2, False),
                 launches_a_object=1)]
    numiter = np.array([r["numiter"] for r in host["admom"]])
    phase_line("26 host", t0, "%s; float64 49x49 sims, each object against the batched call's "
               "row (flags, numiter equal; rtol %g + atol %g, pre-psf rtol %g + atol %g; "
               "largest share of it): AdmomFitter %d objects %.3f (numiter mean "
               "%.2f, max %d) %.3f ms/object, K2 %d launches; GaussMom %d %.3f %.3f ms/object, "
               "K2 %d; PGaussMom %d %.3f %.3f ms/object; KSigmaMom %d %.3f %.3f ms/object; "
               "EMFitter %d %.3f %.3f ms/object; GMix.make_image exp n=6 exact and fast, card "
               "against CPU within rtol 1e-12 + 1e-12 of the peak (max err %.3e of the peak), "
               "%.3f ms; K2 %s; total %.1f s"
               % (card_line(), HOST_RTOL, HOST_ATOL, PREPSF_RTOL, PREPSF_ATOL,
                  HOST_N["admom"], shares["admom"], numiter.mean(), numiter.max(), ms["admom"],
                  k2["admom"], HOST_N["gaussmom"], shares["gaussmom"], ms["gaussmom"],
                  k2["gaussmom"], HOST_N["prepsf"], shares["pgauss"], ms["pgauss"],
                  HOST_N["prepsf"], shares["ksigma"], ms["ksigma"], HOST_N["em"],
                  shares["em"], ms["em"], render_err, ms["make_image"],
                  "; ".join("%s %.4f ms (plain %.4f, bound %.5f, %s), %.1f launches an object"
                            % (r["shape"], r["ms"], r["plain_ms"], r["bound_ms"], r["bound_by"],
                               r["launches_a_object"]) for r in rows),
                  time.perf_counter() - t_all))
    return dict(k2_launches={"host " + k: v for k, v in k2.items() if v}, k2_rows=rows)


# ----------------------------------------------------------------------
# the host LM fitters

# phase 27's fits: 64 exp objects (K3), 16 two-band exp objects (K3-mb),
# 8 bdf with the production PriorBDFSep (K3), 8 psf stamps fit by
# Fitter("gauss") without a psf (K3, zero psf covariance), 8 psf stamps
# fit by CoellipFitter(3) and 8 exp objects under a two-gaussian psf
# (run_lm), and PSFFluxFitter on 8 exp objects
FIT_N = {"exp": 64, "mb": 16, "bdf": 8, "psf": 8, "coellip": 8, "psf2": 8, "psfflux": 8}
FIT_ROUTE = {"exp": "K3", "mb": "K3-mb", "bdf": "K3", "psf": "K3", "coellip": "run_lm",
             "psf2": "run_lm"}
FIT_SEED = 27
FIT_NOISE = 0.1
# the gauss psf of the galaxies (T = 0.3 arcsec^2), the two-gaussian psf
# (a full mixture) and the three-gaussian coelliptical psf stamps
FIT_PSF = [0.0, 0.0, 0.0, 0.0, 0.3, 1.0]
FIT_PSF2 = [0.6, 0.0, 0.0, 0.1, 0.01, 0.12, 0.4, 0.0, 0.0, 0.35, -0.02, 0.4]
FIT_COELLIP = [0.0, 0.0, 0.03, -0.02, 0.15, 0.45, 1.3, 0.5, 0.35, 0.15]


def fitter_inputs():
    """phase 27's stamps from numpy (seed FIT_SEED): 49x49 galaxies at
    0.263"/pixel rendered by GMix.make_image on the CPU with numpy noise
    of sigma FIT_NOISE, each with a 25x25 psf stamp and its mixture, and
    a guess jittered about the truth; the psf stamps for the psf fits.
    Returns {group: [dict of numpy arrays and numbers]}"""
    rng = np.random.RandomState(FIT_SEED)
    dims, pdims, scale = nt.sims.DIMS, nt.sims.PSF_DIMS, nt.sims.SCALE
    cen, pcen = (dims[0] - 1) / 2.0, (pdims[0] - 1) / 2.0

    def jac(c):
        return nt.DiagonalJacobian(row=c, col=c, scale=scale)

    def psf_stamp(gm, noise=1e-6):
        im = gm.make_image(pdims, jacobian=jac(pcen), fast_exp=True, device="cpu")
        return im + rng.normal(size=pdims) * noise, np.full(pdims, 1.0 / noise**2)

    psfs = {"gauss": nt.GMixModel(FIT_PSF, "gauss"), "two": nt.GMix(pars=FIT_PSF2)}
    psf_ims = {k: psf_stamp(gm) for k, gm in psfs.items()}

    def galaxy(model, psf, fluxes, extra=()):
        shape = [rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05), rng.uniform(-0.2, 0.2),
                 rng.uniform(-0.2, 0.2), rng.uniform(0.3, 1.0)]
        stamps = []
        for flux in fluxes:
            gm = nt.GMixModel(shape + list(extra) + [flux], model)
            im = gm.convolve(psfs[psf]).make_image(dims, jacobian=jac(cen), fast_exp=True,
                                                   device="cpu")
            stamps.append((im + rng.normal(size=dims) * FIT_NOISE,
                           np.full(dims, 1.0 / FIT_NOISE**2)))
        truth = np.array(shape + list(extra) + list(fluxes))
        guess = truth * rng.uniform(0.9, 1.1, truth.size)
        guess[:2] = truth[:2] + rng.uniform(-0.02, 0.02, 2)
        return dict(stamps=stamps, psf=psf, guess=guess)

    out = {
        "exp": [galaxy("exp", "gauss", [rng.uniform(50, 200)]) for _ in range(FIT_N["exp"])],
        "mb": [galaxy("exp", "gauss", list(rng.uniform(50, 200, 2)))
               for _ in range(FIT_N["mb"])],
        "bdf": [galaxy("bdf", "gauss", [rng.uniform(50, 200)], [rng.uniform(0.2, 0.8)])
                for _ in range(FIT_N["bdf"])],
        "psf2": [galaxy("exp", "two", [rng.uniform(50, 200)]) for _ in range(FIT_N["psf2"])],
    }
    for g in out["bdf"]:
        g["guess"][5] = 0.5
    out["psf"] = [dict(stamps=[psf_ims["gauss"]], psf=None,
                       guess=np.array([0.0, 0.0, 0.0, 0.0, FIT_PSF[4], 1.0])
                       * rng.uniform(0.95, 1.05, 6)) for _ in range(FIT_N["psf"])]
    out["coellip"] = [dict(stamps=[psf_stamp(nt.GMixCoellip(FIT_COELLIP), noise=1e-5)],
                           psf=None, guess=np.array(FIT_COELLIP) * rng.uniform(0.95, 1.05, 10))
                      for _ in range(FIT_N["coellip"])]
    return out, psf_ims


def fitter_observations(obj, psf_ims, device):
    """an input of fitter_inputs as the fit's observation on device: an
    Observation with its psf Observation and mixture, or a
    MultiBandObsList of one epoch a band"""
    dims, pdims, scale = nt.sims.DIMS, nt.sims.PSF_DIMS, nt.sims.SCALE

    def jac(d):
        return nt.DiagonalJacobian(row=(d[0] - 1) / 2.0, col=(d[1] - 1) / 2.0, scale=scale)

    def one(im, wt):
        if obj["psf"] is None:
            return nt.Observation(im, weight=wt, jacobian=jac(im.shape), device=device)
        pim, pwt = psf_ims[obj["psf"]]
        gm = nt.GMixModel(FIT_PSF, "gauss") if obj["psf"] == "gauss" else nt.GMix(pars=FIT_PSF2)
        psf = nt.Observation(pim, weight=pwt, jacobian=jac(pdims), gmix=gm, device=device)
        return nt.Observation(im, weight=wt, jacobian=jac(dims), psf=psf, device=device)

    if len(obj["stamps"]) == 1:
        return one(*obj["stamps"][0])
    mb = nt.MultiBandObsList()
    for stamp in obj["stamps"]:
        ol = nt.ObsList()
        ol.append(one(*stamp))
        mb.append(ol)
    return mb


def group_fitter(group):
    """the fitter of a group of phase 27's fits"""
    if group == "bdf":
        return nt.Fitter("bdf", prior=bdf_prior())
    if group == "psf":
        return nt.Fitter("gauss")
    if group == "coellip":
        return nt.CoellipFitter(3)
    return nt.Fitter("exp")


def fitter_columns(res):
    """the compared fields of a group's results as [N, ...] float64
    tensors (s2n 0 where a fit failed) and flags and nfev"""
    if "nfev" not in res[0]:
        cols = {k: torch.tensor([float(r[k]) for r in res], dtype=torch.float64)
                for k in ("flux", "flux_err", "chi2per")}
        nfev = torch.zeros(len(res), dtype=torch.int32)
    else:
        cols = {k: torch.tensor(np.stack([r[k] for r in res]), dtype=torch.float64)
                for k in ("pars", "pars_err")}
        cols["s2n"] = torch.tensor([float(r.get("s2n", 0.0)) for r in res], dtype=torch.float64)
        nfev = torch.tensor([r["nfev"] for r in res], dtype=torch.int32)
    return dict(cols, flags=torch.tensor([r["flags"] for r in res], dtype=torch.int32),
                nfev=nfev)


def fitter_fits(device, inputs, timed=False):
    """phase 27's fits of inputs (fitter_inputs) on device: {group:
    compared columns}, and with timed the ms an object of each group and
    each group's K3, K3-mb and K2 launches"""
    inputs, psf_ims = inputs
    cols, ms, counts = {}, {}, {}
    for group, objs in inputs.items():
        obs = [fitter_observations(o, psf_ims, device) for o in objs]
        fitter = group_fitter(group)
        _sync(device)
        lm_solve.launches = lm_solve.launches_mb = gmix_eval.launches = 0
        t = time.perf_counter()
        res = [fitter.go(o, g["guess"]) for o, g in zip(obs, objs)]
        if timed:
            _sync(device)
            ms[group] = (time.perf_counter() - t) * 1e3 / len(objs)
            counts[group] = (lm_solve.launches, lm_solve.launches_mb, gmix_eval.launches)
        routes = {r.route for r in res}
        if routes != {FIT_ROUTE[group]}:
            raise SmokeFailure("host Fitter %s: routes %s, expected %s"
                               % (group, routes, FIT_ROUTE[group]))
        cols[group] = fitter_columns(res)
    flux = nt.PSFFluxFitter()
    obs = [fitter_observations(o, psf_ims, device) for o in inputs["exp"][:FIT_N["psfflux"]]]
    _sync(device)
    lm_solve.launches = lm_solve.launches_mb = gmix_eval.launches = 0
    t = time.perf_counter()
    res = [flux.go(o) for o in obs]
    if timed:
        _sync(device)
        ms["psfflux"] = (time.perf_counter() - t) * 1e3 / len(obs)
        counts["psfflux"] = (lm_solve.launches, lm_solve.launches_mb, gmix_eval.launches)
    cols["psfflux"] = fitter_columns(res)
    return cols, ms, counts


def fitter_cpu_results():
    """phase 27's fits on the CPU (the kernels' plain versions)"""
    return fitter_fits("cpu", fitter_inputs())[0]


def fitter_k3_rows(device, inputs):
    """K3 on one exp fit's inputs and K3-mb on one two-band fit's, at B =
    1 in float64: against their plain versions on the same card inputs
    (per_lane_diff's LM tolerance) and timed beside their bounds"""
    inputs, psf_ims = inputs
    rows = []
    for group, mb in (("exp", False), ("mb", True)):
        obj = inputs[group][0]
        obs = fitter_observations(obj, psf_ims, device)
        seen = {}
        name = "lm_solve_mb" if mb else "lm_solve"
        solve = getattr(lm_solve, name)

        def spy(*a, **kw):
            seen["args"], seen["conf"], seen["kw"] = a[:9 if mb else 8], a[9 if mb else 8], kw
            return solve(*a, **kw)

        with mock.patch.object(lm_solve, name, spy):
            nt.Fitter("exp").go(obs, obj["guess"])
        args, conf, kw = seen["args"], seen["conf"], seen["kw"]
        state = solve(*args, conf, "exp", None, **kw)
        plain_fn = lm_solve.lm_solve_mb_plain if mb else lm_solve.lm_solve_plain
        plain, _, plain_ms = timed_call(lambda: plain_fn(*args, conf, "exp", None, **kw))
        a = solve_cols(tlm._normal_epilogue(state, args[1], args[2], conf,
                                            torch.sum(args[-2] > 0)))
        b = solve_cols(tlm._normal_epilogue(plain, args[1], args[2], conf,
                                            torch.sum(args[-2] > 0)))
        max_abs, _, _ = per_lane_diff(a, b, "host Fitter %s at B = 1 against its plain version"
                                      % ("K3-mb" if mb else "K3"))
        t_ms = time_ms(lambda: solve(*args, conf, "exp", None, **kw), 20)
        b_ms, by = (k3mb_bound if mb else k3_bound)(args, state, "exp")
        rows.append(dict(shape="host Fitter exp %s[1x%s] float64"
                         % ("nband 2 " if mb else "", "x".join(map(str, args[-1].shape[1:]))),
                         ms=t_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                         max_abs_err=max_abs, nfev=int(state["nfev"][0]), launches_a_object=1))
    return rows


def fitter_phase(device, t_all, cpu_side):
    """phase 27: the host LM fitters on the card in float64, held fit by
    fit to the same fits on the CPU; K3 and K3-mb at B = 1 timed"""
    t0 = time.perf_counter()
    inputs = fitter_inputs()
    cols, ms, counts = fitter_fits(device, inputs, timed=True)
    # one K3 or K3-mb launch a fit of those routes, none for run_lm and
    # PSFFluxFitter
    want = {g: (FIT_N[g] if FIT_ROUTE.get(g) == "K3" else 0,
                FIT_N[g] if FIT_ROUTE.get(g) == "K3-mb" else 0) for g in counts}
    got = {g: c[:2] for g, c in counts.items()}
    if got != want:
        raise SmokeFailure("host Fitter: K3 and K3-mb launches %s, expected %s" % (got, want))
    _, cpu = cpu_side.get("27 fitters")
    worst = {}
    for group, c in cols.items():
        keys = ("flux", "flux_err", "chi2per") if group == "psfflux" else ("pars", "pars_err",
                                                                           "s2n")
        worst[group] = per_lane_diff(c, cpu[group], "host %s card against CPU" % group,
                                     keys=keys)
    rows = fitter_k3_rows(device, inputs)
    k3 = sum(counts[g][0] for g in counts)
    k3mb = sum(counts[g][1] for g in counts)
    k2 = sum(counts[g][2] for g in counts)
    phase_line("27 fitters", t0, "%s; float64 49x49, card against CPU per fit (flags equal, "
               "rtol 1e-5 + atol 1e-7, nfev within 2; max rel): %s; K3 %d, K3-mb %d, K2 %d "
               "launches; %s; total %.1f s"
               % (card_line(), ", ".join(
                   "%s %d %s %.3f ms/object (%.1e)" % (g, FIT_N[g], FIT_ROUTE.get(g, "K2"), ms[g],
                                                      worst[g][1]) for g in cols),
                  k3, k3mb, k2, "; ".join(
                      "%s %.4f ms (plain %.4f, bound %.6f, %s), nfev %d"
                      % (r["shape"], r["ms"], r["plain_ms"], r["bound_ms"], r["bound_by"],
                         r["nfev"]) for r in rows), time.perf_counter() - t_all))
    return dict(k3_launches=k3, k3mb_launches=k3mb, k2_launches=k2, rows=rows,
                max_abs_err=max(r["max_abs_err"] for r in rows))


# ----------------------------------------------------------------------
# the metacal bootstrap and the k-space fitters (phase 28)

# the objects of each group and the seed of its stamps and draws, one a
# group
BOOT_N = {"oracle": 16, "fitgauss": 8, "dilate": 4, "kspace": 4}
BOOT_SEEDS = {"oracle": 28, "fitgauss": 29, "dilate": 30, "kspace": 31}
BOOT_GROUPS = tuple(BOOT_N)
BOOT_TYPES = ["noshear", "1p", "1m"]
BOOT_NOISE = 1e-5
BOOT_MOM_KEYS = ("e1", "e2", "T", "flux", "s2n")
BOOT_LM_KEYS = ("pars", "pars_err", "s2n")
# the k-space fits, each on the stamps and from the guess of its test in
# the reference's tests/test_kspace_fitters.py: 49x49 stamps (65x65 for
# exp's larger galaxy, 33x33 for a psf stamp) at the pixel scale of the
# sims, the postage stamps the batched pipeline measures. Each is (stamp
# dims, galaxy model, its (g1, g2, T, flux), the gaussian psf's (g1,
# g2) of T 0.3 or None for no psf, noise, the fit's guess); psfflux's
# exp galaxy has r50 0.5 (T 0.5325), its template's r50
_R50_EXP_T2 = 1.6783469900166605 * np.sqrt(2.0 / 6.0)
KSPACE_FITS = {
    "gauss": ((49, 49), "gauss", (0.05, -0.03, 0.9, 100.0), (0.0, 0.0), 1e-4,
              [0.0, 0.0, 0.0, 0.0, 1.1 * float(nt.moments.T_to_r50(0.9)), 90.0]),
    "exp": ((65, 65), "exp", (0.04, 0.02, 2.0, 100.0), (0.0, 0.0), 1e-3,
            [0.0, 0.0, 0.0, 0.0, _R50_EXP_T2, 80.0]),
    "spergel": ((49, 49), "gauss", (0.02, 0.0, 0.9, 100.0), (0.0, 0.0), 1e-3,
                [0.0, 0.0, 0.0, 0.0, 0.45, 0.8, 90.0]),
    "moffat": ((33, 33), "turb", (0.02, -0.01, 0.3, 100.0), None, 1e-3,
               [0.0, 0.0, 0.0, 0.0, 0.35, 3.0, 90.0]),
    "psfflux": ((49, 49), "exp", (0.0, 0.0, 0.5325, 100.0), (0.02, -0.01), 1e-5, None),
}


def _boot_stamp(rng, dims, gal, psf, noise):
    """(image, weight, center, psf image, psf weight) of gal under psf
    (None: no psf) on a dims stamp whose center is jittered by up to half
    a pixel, plus noise, the psf on a 25x25 stamp"""
    scale = nt.sims.SCALE
    cen = (np.array(dims) - 1.0) / 2.0 + rng.uniform(-0.5, 0.5, size=2)
    jac = nt.DiagonalJacobian(row=cen[0], col=cen[1], scale=scale)
    pjac = nt.DiagonalJacobian(row=12.0, col=12.0, scale=scale)
    img = (gal if psf is None else gal.convolve(psf)).make_image(dims, jacobian=jac,
                                                                  device="cpu")
    img = img + rng.normal(size=dims) * noise
    pimg = None if psf is None else psf.make_image((25, 25), jacobian=pjac, device="cpu")
    return img, np.full(dims, 1.0 / noise**2), cen, pimg, np.full((25, 25), 1e10)


def bootstrap_inputs(group):
    """phase 28's stamps of a group, numpy from its seed (BOOT_SEEDS):
    the reference's shear oracle (tests/test_metacal.py:204-249: 49x49
    exp galaxies of T 0.5 sheared by (0.02, 0) under a turb psf, noise
    BOOT_NOISE) for "oracle", its stamps at noise 1e-3 for "fitgauss"
    and "dilate"; for "kspace" a dict of each k-space fit's stamps
    (KSPACE_FITS)"""
    rng = np.random.RandomState(BOOT_SEEDS[group])
    n = BOOT_N[group]
    if group == "kspace":
        out = {}
        for name, (dims, model, pars, psf_g, noise, _) in KSPACE_FITS.items():
            gal = nt.GMixModel([0.0, 0.0, *pars], model)
            psf = None if psf_g is None else nt.GMixModel([0.0, 0.0, *psf_g, 0.3, 1.0], "gauss")
            out[name] = [_boot_stamp(rng, dims, gal, psf, noise) for _ in range(n)]
        return out
    gal = nt.GMixModel([0.0, 0.0, 0.0, 0.0, 0.5, 100.0], "exp").get_sheared(0.02, 0.0)
    psf = nt.GMixModel([0.0, 0.0, 0.025, -0.01, 0.27, 1.0], "turb")
    noise = BOOT_NOISE if group == "oracle" else 1e-3
    return [_boot_stamp(rng, (49, 49), gal, psf, noise) for _ in range(n)]


def bootstrap_observation(item, device):
    img, wt, cen, pimg, pwt = item
    scale = nt.sims.SCALE
    jac = nt.DiagonalJacobian(row=cen[0], col=cen[1], scale=scale)
    pjac = nt.DiagonalJacobian(row=12.0, col=12.0, scale=scale)
    psf = None if pimg is None else nt.Observation(pimg, weight=pwt, jacobian=pjac,
                                                   device=device)
    return nt.Observation(img, weight=wt, jacobian=jac, psf=psf, device=device)


def bootstrap_runs(group, device, inputs):
    """phase 28's group on device in float64, every bootstrap's draws
    from a RandomState of the group's seed: the shear oracle's
    MetacalBootstrapper (psf='gauss', Runner(GaussMom(1.2)),
    PSFRunner(Fitter("gauss"), SimplePSFGuesser(guess_from_moms=True),
    ntry=3), noshear, 1p, 1m), Runner(Fitter("exp"), TFluxGuesser) under
    psf='fitgauss' (its five types) and 'dilate' (all nine), or the
    k-space fits of KSPACE_FITS (KSpaceFitter gauss and exp,
    GalsimSpergelFitter, GalsimMoffatFitter on make_kobs of the psf
    stamps, GalsimPSFFluxFitter with an exp template). Returns {subgroup:
    [N] columns} and the first object's metacal images of each type"""
    rng = np.random.RandomState(BOOT_SEEDS[group])
    if group == "kspace":
        cols = {}
        for name, items in inputs.items():
            obs = [bootstrap_observation(x, device) for x in items]
            if name == "psfflux":
                fitter = nt.fitting.GalsimPSFFluxFitter(model={"model": "exp", "r50": 0.5})
                cols[name] = fitter_columns([fitter.go(o) for o in obs])
                continue
            fitter = {"spergel": nt.fitting.GalsimSpergelFitter,
                      "moffat": nt.fitting.GalsimMoffatFitter}.get(
                          name, functools.partial(nt.KSpaceFitter, name))()
            guess = np.array(KSPACE_FITS[name][-1])
            res = [fitter.go(nt.make_kobs(o) if name == "moffat" else o, guess) for o in obs]
            # the round model's s/n of a k-space fit as its s2n
            cols[name] = dict(fitter_columns(res), s2n=torch.tensor(
                [float(r.get("s2n_r", 0.0)) for r in res], dtype=torch.float64))
        return cols, {}
    obs = [bootstrap_observation(x, device) for x in inputs]
    psf_runner = nt.PSFRunner(fitter=nt.Fitter("gauss"), ntry=3,
                              guesser=nt.guessers.SimplePSFGuesser(rng=rng, guess_from_moms=True))
    if group == "oracle":
        runner = nt.Runner(nt.GaussMom(fwhm=1.2))
        kw = dict(psf="gauss", types=BOOT_TYPES)
    else:
        runner = nt.Runner(nt.Fitter("exp"), ntry=2, guesser=nt.guessers.TFluxGuesser(
            rng=rng, T=0.6, flux=100.0))
        kw = dict(psf=group)
    boot = nt.MetacalBootstrapper(runner=runner, psf_runner=psf_runner, rng=rng, **kw)
    out = [boot.go(o) for o in obs]
    types = list(out[0][0])
    routes = {o[1][t].psf.meta["result"].route for o in out for t in types}
    if group != "oracle":
        routes |= {o[0][t].route for o in out for t in types}
    if routes != {"K3"}:
        raise SmokeFailure("host metacal bootstrap %s: fit routes %s, not K3" % (group, routes))
    if group == "oracle":
        cols = {t: dict({k: torch.tensor([float(o[0][t][k]) for o in out], dtype=torch.float64)
                         for k in BOOT_MOM_KEYS},
                        flags=torch.tensor([int(o[0][t]["flags"]) for o in out]),
                        nfev=torch.zeros(len(out), dtype=torch.int32)) for t in types}
    else:
        cols = {t: fitter_columns([o[0][t] for o in out]) for t in types}
    images = {t: (out[0][1][t].image.copy(), out[0][1][t].psf.image.copy()) for t in types}
    return cols, images


def run_lm_replay_check(item, device):
    """a Moffat k-space fit of the stamp item on the card, run_lm's steps
    replayed from a CUDA graph, against the same fit's eager steps:
    flags, nfev, pars and pars_err bitwise equal"""
    kobs = nt.make_kobs(bootstrap_observation(item, device))
    guess = np.array(KSPACE_FITS["moffat"][-1])
    replayed = nt.fitting.GalsimMoffatFitter().go(kobs, guess)
    with eager_steps():
        eager = nt.fitting.GalsimMoffatFitter().go(kobs, guess)
    differ = [k for k in ("flags", "nfev", "pars", "pars_err")
              if not np.array_equal(np.asarray(eager[k]), np.asarray(replayed[k]))]
    if differ:
        raise SmokeFailure("run_lm's replayed steps differ from its eager steps in %s" % differ)


def bootstrap_cpu_results(group):
    """phase 28's group on the CPU (the kernels' plain versions)"""
    return bootstrap_runs(group, "cpu", bootstrap_inputs(group))


def oracle_m(cols):
    """the oracle's multiplicative bias: <e1> of noshear over R11 from 1p
    and 1m, against the applied 0.02"""
    e1 = {t: float(cols[t]["e1"].mean()) for t in BOOT_TYPES}
    R11 = (e1["1p"] - e1["1m"]) / (2 * nt.metacal.DEFAULT_STEP)
    return e1["noshear"] / R11 / 0.02 - 1, R11


def counted_fits():
    """wrappers that count the consumers of K3 and K2 launches in the
    host API: Fitter.go (one K3 launch a K3-route fit, and one K2 launch
    for the s/n sums of an unflagged one), GaussMom.go (one K2 launch),
    AdmomFitter.go (2 numiter + 1 K2 launches) and SimplePSFGuesser's
    moments guess (one K2 launch). Returns the patches and the counts"""
    counts = {"k3": 0, "k2": 0}

    def fitter(out, guesser):
        if out.route == "K3":
            counts["k3"] += 1
        counts["k2"] += int(out["flags"] == 0)

    def moments(out, guesser):
        counts["k2"] += 1

    def admom(out, guesser):
        counts["k2"] += 2 * int(out["numiter"]) + 1

    def guess(out, guesser):
        counts["k2"] += int(guesser.guess_from_moms)

    def wrap(cls, name, count):
        fn = getattr(cls, name)

        @functools.wraps(fn)
        def wrapper(self, *a, **kw):
            out = fn(self, *a, **kw)
            count(out, self)
            return out
        return mock.patch.object(cls, name, wrapper)

    return [wrap(nt.Fitter, "go", fitter), wrap(nt.GaussMom, "go", moments),
            wrap(nt.AdmomFitter, "go", admom),
            wrap(nt.guessers.SimplePSFGuesser, "__call__", guess)], counts


def bootstrap_phase(device, t_all, cpu_side):
    """phase 28: the host metacal bootstrap and the k-space fitters in
    float64 on the card, a seed a group: the reference's shear oracle on
    BOOT_N["oracle"] objects (flags 0, |m| < 1e-3), MetacalBootstrapper
    with Runner(Fitter("exp")) under psf='fitgauss' and 'dilate', the
    k-space fits; every result held to the same run on the CPU
    (CpuSide): the moments to rtol 1e-10 + atol 1e-12, the LM fields to
    rtol 1e-5 + atol 1e-7 with nfev within 2, flags equal; the first
    object's metacal images and psf images of each psf mode to rtol
    1e-8 + atol 1e-10 of the peak; K3 and K2 launches counted from 0
    against the fits and measurements that launch them (counted_fits),
    none by the k-space fits; the k-space fits' mean nfev"""
    t0 = time.perf_counter()
    ms, launches, worst, cols = {}, {}, {}, {}
    img_err = 0.0
    for group in BOOT_GROUPS:
        inputs = bootstrap_inputs(group)
        patches, counts = counted_fits()
        _sync(device)
        lm_solve.launches = lm_solve.launches_mb = gmix_eval.launches = 0
        t = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            cols[group], images = bootstrap_runs(group, device, inputs)
        _sync(device)
        ms[group] = (time.perf_counter() - t) * 1e3 / BOOT_N[group]
        launches[group] = (lm_solve.launches, gmix_eval.launches)
        want = (0, 0) if group == "kspace" else (counts["k3"], counts["k2"])
        if launches[group] != want or lm_solve.launches_mb:
            raise SmokeFailure("host metacal bootstrap %s: K3 and K2 launched %s times (K3-mb "
                               "%d), expected %s" % (group, launches[group],
                                                     lm_solve.launches_mb, want))
        _, (cpu_cols, cpu_images) = cpu_side.get("28 " + group)
        for t, c in cols[group].items():
            if group == "oracle":
                r = per_lane_diff(c, cpu_cols[t], "bootstrap %s %s card against CPU" % (group, t),
                                  rtol=1e-10, atol=1e-12, dnfev=0, keys=BOOT_MOM_KEYS)
            else:
                keys = ("flux", "flux_err", "chi2per") if t == "psfflux" else BOOT_LM_KEYS
                r = per_lane_diff(c, cpu_cols[t], "%s %s card against CPU" % (group, t),
                                  keys=keys)
            worst[group] = max(worst.get(group, 0.0), r[1])
        for t, (im, pim) in images.items():
            for a, b in ((im, cpu_images[t][0]), (pim, cpu_images[t][1])):
                err = np.abs(a - b)
                if not (err <= 1e-10 * np.abs(b).max() + 1e-8 * np.abs(b)).all():
                    raise SmokeFailure("bootstrap %s %s: the metacal image differs from the "
                                       "CPU's by %.3e" % (group, t, err.max()))
                img_err = max(img_err, float((err / np.abs(b).max()).max()))
    run_lm_replay_check(bootstrap_inputs("kspace")["moffat"][0], device)
    flags = {g: int(sum(int((c["flags"] != 0).sum()) for c in cols[g].values())) for g in cols}
    if flags["oracle"]:
        raise SmokeFailure("the shear oracle flagged %d fits" % flags["oracle"])
    m, R11 = oracle_m(cols["oracle"])
    if not abs(m) < 1e-3:
        raise SmokeFailure("the shear oracle's m = %.3e, not below 1e-3" % m)
    nfev = ", ".join("%s %.2f" % (t, float(c["nfev"].double().mean()))
                     for t, c in cols["kspace"].items() if t != "psfflux")
    phase_line("28 bootstrap", t0, "%s; float64, card against CPU (moments rtol 1e-10, LM rtol "
               "1e-5 + atol 1e-7 with nfev within 2; max rel): shear oracle %d objects m=%.3e "
               "R11=%.4f %.3f ms/object (%.1e); %s (k-space nfev a fit: %s; run_lm's replayed "
               "steps bitwise equal to its eager steps); metacal images "
               "within %.1e of the peak; flagged %s; K3 and K2 launches %s (each the K3-route "
               "fits and the GaussMom, admom, s/n and moments-guess calls; none by k-space); "
               "total %.1f s"
               % (card_line(), BOOT_N["oracle"], m, R11, ms["oracle"], worst["oracle"],
                  "; ".join("%s %d objects %.3f ms/object (%.1e)" % (g, BOOT_N[g], ms[g],
                                                                     worst[g])
                            for g in BOOT_GROUPS if g != "oracle"),
                  nfev, img_err, flags, launches, time.perf_counter() - t_all))
    return dict(k3_launches=sum(k for k, _ in launches.values()),
                k2_launches=sum(k for _, k in launches.values()), m=m)


# ----------------------------------------------------------------------
# the rest of the host API (phase 29)

# phase 29's host fits: the objects of each group and the seed of their
# stamps
API_N = {"exp lmbounds": 4, "coellip": 4, "spergel": 2, "kspace exp": 2}
API_SEED = 32
API_ROUTE = {"exp lmbounds": "K3", "coellip": "run_lm", "spergel": "run_lm",
             "kspace exp": "run_lm", "meds": "K3"}
# GMixND over a catalog: the rows, and the samples its fit takes, of a
# 3-d mixture of 8 gaussians; gaussap over a catalog of bdf objects in 3
# bands
GMIXND_ROWS, GMIXND_SAMPLES, GMIXND_NGAUSS = 1000000, 100000, 8
GAP_OBJECTS = 1000000


def lmbounds_prior(kind, nband=1):
    """phase 29's joint priors: the reference test's exp prior with its T
    and flux slots as LMBounds (a box without weight), the production
    PriorBDFSep with LMBounds fluxes, and the joint priors of the
    coellip, Spergel and galsim fits"""
    cen, g = tpriors.CenPrior(0.0, 0.0, 0.263, 0.263), tpriors.GPriorBA(0.3)
    erf = tpriors.TwoSidedErf(-1.0, 0.1, 1e3, 1.0)
    if kind == "exp":
        F = tpriors.LMBounds(1e-4, 1e9)
        return joint_prior.PriorSimpleSep(cen, g, tpriors.LMBounds(0.01, 10.0),
                                          F if nband == 1 else [F] * nband)
    if kind == "bdf":
        F = tpriors.LMBounds(-100.0, 1e9)
        return joint_prior.PriorBDFSep(cen, tpriors.GPriorBA(0.1), erf, tpriors.LogNormal(0.5, 0.1),
                                       F if nband == 1 else [F] * nband)
    F = tpriors.TwoSidedErf(-100.0, 0.1, 1e9, 1.0)
    if kind == "coellip":
        return joint_prior.PriorCoellipSame(3, cen, g, tpriors.LMBounds(1e-4, 10.0), F)
    if kind == "spergel":
        return joint_prior.PriorSpergelSep(cen, g, tpriors.TwoSidedErf(0.01, 0.01, 5.0, 0.1),
                                           tpriors.TwoSidedErf(-0.8, 0.05, 3.5, 0.1), F)
    return joint_prior.PriorGalsimSimpleSep(cen, g, tpriors.LMBounds(0.01, 5.0), F)


def host_api_inputs():
    """phase 29's stamps from numpy (seed API_SEED): exp galaxies under the
    gauss psf as phase 27's (guesses jittered about the truth), the
    coelliptical psf stamps of phase 27, and the Spergel and exp stamps
    and guesses of phase 28's k-space fits (KSPACE_FITS)"""
    rng = np.random.RandomState(API_SEED)
    dims, scale = nt.sims.DIMS, nt.sims.SCALE
    jac = nt.DiagonalJacobian(row=(dims[0] - 1) / 2.0, col=(dims[1] - 1) / 2.0, scale=scale)
    psf = nt.GMixModel(FIT_PSF, "gauss")
    out = {"exp lmbounds": [], "coellip": []}
    for _ in range(API_N["exp lmbounds"]):
        truth = np.array([rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05),
                          rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2), rng.uniform(0.3, 1.0),
                          rng.uniform(50, 200)])
        im = nt.GMixModel(truth, "exp").convolve(psf).make_image(dims, jacobian=jac,
                                                                 fast_exp=True, device="cpu")
        guess = truth * rng.uniform(0.9, 1.1, 6)
        guess[:2] = truth[:2] + rng.uniform(-0.02, 0.02, 2)
        out["exp lmbounds"].append(dict(stamps=[(im + rng.normal(size=dims) * FIT_NOISE,
                                                 np.full(dims, 1.0 / FIT_NOISE**2))],
                                        psf="gauss", guess=guess))
    pdims = nt.sims.PSF_DIMS
    pjac = nt.DiagonalJacobian(row=(pdims[0] - 1) / 2.0, col=(pdims[1] - 1) / 2.0, scale=scale)
    cim = nt.GMixCoellip(FIT_COELLIP).make_image(pdims, jacobian=pjac, fast_exp=True,
                                                  device="cpu")
    for _ in range(API_N["coellip"]):
        out["coellip"].append(dict(stamps=[(cim + rng.normal(size=pdims) * 1e-5,
                                            np.full(pdims, 1e10))], psf=None,
                                   guess=np.array(FIT_COELLIP) * rng.uniform(0.95, 1.05, 10)))
    for group, name in (("spergel", "spergel"), ("kspace exp", "exp")):
        kdims, model, pars, psf_g, noise, guess = KSPACE_FITS[name]
        gal = nt.GMixModel([0.0, 0.0, *pars], model)
        kpsf = nt.GMixModel([0.0, 0.0, *psf_g, 0.3, 1.0], "gauss")
        out[group] = [dict(item=_boot_stamp(rng, kdims, gal, kpsf, noise), guess=np.array(guess))
                      for _ in range(API_N[group])]
    return out


def host_api_fits(device, inputs):
    """phase 29's fits on device in float64: {group: compared columns},
    and the K3, K3-mb and K2 launches of each group"""
    fitters = {"exp lmbounds": nt.Fitter("exp", prior=lmbounds_prior("exp")),
               "coellip": nt.CoellipFitter(3, prior=lmbounds_prior("coellip")),
               "spergel": nt.KSpaceFitter("spergel", prior=lmbounds_prior("spergel")),
               "kspace exp": nt.KSpaceFitter("exp", prior=lmbounds_prior("galsim"))}
    cols, counts = {}, {}
    for group, objs in inputs.items():
        if "item" in objs[0]:
            obs = [bootstrap_observation(o["item"], device) for o in objs]
        else:
            obs = [fitter_observations(o, {"gauss": None}, device) if o["psf"] is None
                   else host_api_observation(o, device) for o in objs]
        _sync(device)
        lm_solve.launches = lm_solve.launches_mb = gmix_eval.launches = 0
        res = [fitters[group].go(o, g["guess"]) for o, g in zip(obs, objs)]
        _sync(device)
        counts[group] = (lm_solve.launches, lm_solve.launches_mb, gmix_eval.launches)
        # the k-space fits have no kernel route: run_lm, always
        routes = {getattr(r, "route", "run_lm") for r in res}
        if routes != {API_ROUTE[group]}:
            raise SmokeFailure("host fits %s: routes %s, expected %s"
                               % (group, routes, API_ROUTE[group]))
        cols[group] = fitter_columns(res)
    return cols, counts


def host_api_observation(obj, device):
    """an exp input of host_api_inputs as its Observation on device, its
    psf Observation carrying the gauss mixture"""
    dims, pdims, scale = nt.sims.DIMS, nt.sims.PSF_DIMS, nt.sims.SCALE
    psf_gm = nt.GMixModel(FIT_PSF, "gauss")
    pjac = nt.DiagonalJacobian(row=(pdims[0] - 1) / 2.0, col=(pdims[1] - 1) / 2.0, scale=scale)
    pim = psf_gm.make_image(pdims, jacobian=pjac, fast_exp=True, device="cpu")
    psf = nt.Observation(pim, weight=np.full(pdims, 1e12), jacobian=pjac, gmix=psf_gm,
                         device=device)
    jac = nt.DiagonalJacobian(row=(dims[0] - 1) / 2.0, col=(dims[1] - 1) / 2.0, scale=scale)
    im, wt = obj["stamps"][0]
    return nt.Observation(im, weight=wt, jacobian=jac, psf=psf, device=device)


class ScriptMEDS(nt.medsreaders.NGMixMEDSMixin):
    """an in-memory MEDS of one object with one cutout (the raw-access
    interface NGMixMEDSMixin reads): an exp galaxy under the gauss psf
    on a 49x49 stamp at 0.263"/pixel, from numpy (seed API_SEED + 1)"""

    def __init__(self, device):
        self.device = device
        rng = np.random.RandomState(API_SEED + 1)
        dims, pdims = nt.sims.DIMS, nt.sims.PSF_DIMS
        self.cen = (dims[0] - 1) / 2.0 + rng.uniform(-0.5, 0.5, 2)
        self.truth = np.array([0.0, 0.0, 0.1, -0.05, 0.6, 120.0])
        jac = nt.DiagonalJacobian(row=self.cen[0], col=self.cen[1], scale=nt.sims.SCALE)
        psf = nt.GMixModel(FIT_PSF, "gauss")
        im = nt.GMixModel(self.truth, "exp").convolve(psf).make_image(dims, jacobian=jac,
                                                                      device="cpu")
        self.cuts = {"image": im + rng.normal(size=dims) * FIT_NOISE,
                     "weight": np.full(dims, 1.0 / FIT_NOISE**2),
                     "noise": rng.normal(size=dims) * FIT_NOISE}
        pjac = nt.DiagonalJacobian(row=(pdims[0] - 1) / 2.0, col=(pdims[1] - 1) / 2.0,
                                   scale=nt.sims.SCALE)
        self.psf_im = psf.make_image(pdims, jacobian=pjac, device="cpu")
        self._cat = np.zeros(1, dtype=[("id", "i8"), ("ncutout", "i4"),
                                       ("file_id", "i4", (1,)), ("orig_row", "f8", (1,)),
                                       ("orig_col", "f8", (1,)), ("orig_start_row", "i8", (1,)),
                                       ("orig_start_col", "i8", (1,)),
                                       ("psf_cutout_row", "f8", (1,)),
                                       ("psf_cutout_col", "f8", (1,))])
        c = self._cat
        c["id"], c["ncutout"] = 7, 1
        c["orig_row"][0, 0], c["orig_col"][0, 0] = 500 + self.cen[0], 800 + self.cen[1]
        c["orig_start_row"][0, 0], c["orig_start_col"][0, 0] = 500, 800
        c["psf_cutout_row"][0, 0] = c["psf_cutout_col"][0, 0] = (pdims[0] - 1) / 2.0

    size = 1

    def get_cutout(self, iobj, icut, type="image"):
        if type not in self.cuts:
            raise RuntimeError("no %s cutouts" % type)
        return self.cuts[type].copy()

    def get_jacobian(self, iobj, icut):
        c = self._cat
        return dict(row0=c["orig_row"][iobj, icut] - c["orig_start_row"][iobj, icut],
                    col0=c["orig_col"][iobj, icut] - c["orig_start_col"][iobj, icut],
                    dudrow=0.0, dudcol=nt.sims.SCALE, dvdrow=nt.sims.SCALE, dvdcol=0.0)

    def get_image_info(self):
        return np.array([("/meds/epoch_0.fits", 1.0)],
                        dtype=[("image_path", "U32"), ("scale", "f8")])

    def has_psf(self):
        return True

    def get_psf(self, iobj, icut):
        return self.psf_im.copy()


def meds_fit(device):
    """the MEDS object's observation list on device and its exp fit
    (Fitter, K3), the psf's mixture set to the gauss psf: the fit's
    columns and the observation's image, weight and jacobian centre"""
    meds = ScriptMEDS(device)
    obslist = nt.medsreaders.MultiBandNGMixMEDS([meds], device=device).get_mbobs(0)[0]
    obs = obslist[0]
    obs.psf.set_gmix(nt.GMixModel(FIT_PSF, "gauss"))
    res = nt.Fitter("exp").go(obs, meds.truth * np.array([1, 1, 1.1, 0.9, 1.05, 0.95]))
    if res.route != "K3":
        raise SmokeFailure("the MEDS object's fit took %s, not K3" % res.route)
    return fitter_columns([res]), (obs.image, obs.weight, np.array(obs.jacobian.get_cen()))


def gmixnd_mixture(device):
    """GMixND.fit of GMIXND_NGAUSS gaussians to GMIXND_SAMPLES samples of
    a 3-d mixture of as many, drawn in numpy (seed API_SEED + 2), on
    device"""
    rng = np.random.RandomState(API_SEED + 2)
    means = rng.normal(scale=2.0, size=(GMIXND_NGAUSS, 3))
    A = rng.normal(size=(GMIXND_NGAUSS, 3, 3)) * 0.5
    comp = rng.randint(GMIXND_NGAUSS, size=GMIXND_SAMPLES)
    samples = means[comp] + np.einsum("nij,nj->ni", A[comp], rng.normal(size=(GMIXND_SAMPLES, 3)))
    samples += 0.4 * rng.normal(size=samples.shape)
    gm = nt.GMixND(rng=np.random.RandomState(API_SEED + 3), device=device)
    try:
        gm.fit(samples, GMIXND_NGAUSS, n_iter=500)
    except ImportError:
        # no sklearn on this host: the mixture the samples are drawn from
        # (weights 1/8, covariances A A^T + 0.16 I)
        cov = A @ np.swapaxes(A, 1, 2) + 0.16 * np.eye(3)
        gm.set_mixture(np.full(GMIXND_NGAUSS, 1.0 / GMIXND_NGAUSS), means, cov)
        gm.fitted = False
    return gm


def catalog_rows():
    """the GMixND rows [GMIXND_ROWS, 3] and the gaussap catalog
    [GAP_OBJECTS, 9] (bdf: row, col, g1, g2, T, fracdev, 3 fluxes) from
    numpy (seed API_SEED + 4)"""
    rng = np.random.RandomState(API_SEED + 4)
    rows = rng.normal(scale=2.5, size=(GMIXND_ROWS, 3))
    n = GAP_OBJECTS
    cat = np.column_stack([rng.normal(scale=0.1, size=(n, 2)),
                           rng.uniform(-0.75, 0.75, (n, 2)), rng.uniform(-0.2, 3.0, n),
                           rng.uniform(0.0, 1.0, n), rng.uniform(1.0, 1e3, (n, 3))])
    return rows, cat


def host_api_cpu_results(group):
    """phase 29's CPU sides: the host fits of a group, or ("support") the
    GMixND mixture and its ln(prob) of the rows and the MEDS object's
    fit"""
    if group != "support":
        inputs = host_api_inputs()
        return host_api_fits("cpu", {group: inputs[group]})[0][group]
    gm = gmixnd_mixture("cpu")
    rows, _ = catalog_rows()
    return dict(mixture=(gm.weights, gm.means, gm.covars), lnprob=gm.get_lnprob_array(rows),
                fitted=getattr(gm, "fitted", True), meds=meds_fit("cpu"))


def gaussap_cpu_results(cat):
    """the aperture fluxes and flags of a part of the catalog on the CPU,
    as tensors (CpuSide concatenates the parts)"""
    flux, flags = nt.gaussap.get_gaussap_flux(cat.numpy(), "bdf", 2.0, device="cpu")
    return {"flux": torch.as_tensor(flux), "flags": torch.as_tensor(flags)}


def submit_host_api_cpu(side):
    """phase 29's CPU sides: each group's fits, the support job and the
    catalog's aperture fluxes split over the workers"""
    for group in API_N:
        side.submit("29 " + group, host_api_cpu_results, (), group)
    side.submit("29 support", host_api_cpu_results, (), "support")
    side.submit("29 gaussap", gaussap_cpu_results, (torch.as_tensor(catalog_rows()[1]),))


def host_api_phase(device, t_all, cpu_side):
    """phase 29: the rest of the host API on the card in float64, each
    result held to the CPU's: the host fits with the joint priors of
    LMBounds, coellip, Spergel and galsim (phase 27's criterion, routes
    and launches counted from 0), GMixND.get_lnprob_array over
    GMIXND_ROWS rows of the mixture GMixND.fit made (timed with
    profiling.timed and its sync), get_gaussap_flux over GAP_OBJECTS bdf
    objects in 3 bands (rtol 1e-12, flags equal) and a MEDS object's
    observation and fit"""
    t0 = time.perf_counter()
    cols, counts = host_api_fits(device, host_api_inputs())
    worst = {}
    for group, c in cols.items():
        _, cpu = cpu_side.get("29 " + group)
        keys = ("pars", "pars_err") if group in ("spergel", "kspace exp") else (
            "pars", "pars_err", "s2n")
        worst[group] = per_lane_diff(c, cpu, "host %s card against CPU" % group, keys=keys)[1]
    want = {g: (API_N[g] if API_ROUTE[g] == "K3" else 0, 0) for g in counts}
    if {g: c[:2] for g, c in counts.items()} != want:
        raise SmokeFailure("phase 29's fits: K3 and K3-mb launches %s, expected %s"
                           % ({g: c[:2] for g, c in counts.items()}, want))
    _, sup = cpu_side.get("29 support")
    _, gap = cpu_side.get("29 gaussap")
    lm_solve.launches = gmix_eval.launches = 0
    mcols, (image, weight, cen) = meds_fit(device)
    meds_launches = (lm_solve.launches, gmix_eval.launches)
    cimage, cweight, ccen = sup["meds"][1]
    if not (np.array_equal(image, cimage) and np.array_equal(weight, cweight)
            and np.array_equal(cen, ccen)):
        raise SmokeFailure("the MEDS observation on the card differs from the CPU's")
    worst["meds"] = per_lane_diff(mcols, sup["meds"][0], "the MEDS object's fit card against "
                                  "CPU", keys=("pars", "pars_err", "s2n"))[1]
    rows, cat = catalog_rows()
    gm = nt.GMixND(*sup["mixture"], device=device)
    profiling.report(reset=True)
    with profiling.timed("gmixnd", sync=gm._mixture_tensors()):
        lnp = gm.get_lnprob_device(rows)
    with profiling.timed("gmixnd", sync=lnp):
        lnp = gm.get_lnprob_device(rows)
    gmixnd_s = profiling.report()["gmixnd"][2]
    lnp = lnp.cpu().numpy()
    t_gap = time.perf_counter()
    flux, flags = nt.gaussap.get_gaussap_flux(cat, "bdf", 2.0, device=device)
    gap_s = time.perf_counter() - t_gap
    if not np.array_equal(flags, gap["flags"].numpy()):
        raise SmokeFailure("gaussap flags differ card against CPU on %d objects"
                           % int((flags != gap["flags"].numpy()).any(1).sum()))
    ok = flags == 0
    rel = {}
    for what, a, b in (("GMixND", lnp, sup["lnprob"]),
                       ("gaussap", flux[ok], gap["flux"].numpy()[ok])):
        err = np.abs(a - b) / np.abs(b)
        rel[what] = float(err.max())
        if not rel[what] <= 1e-12:
            raise SmokeFailure("%s card against CPU: max rel %.3e > 1e-12" % (what, rel[what]))
    k3 = sum(c[0] for c in counts.values()) + meds_launches[0]
    k2 = sum(c[2] for c in counts.values()) + meds_launches[1]
    phase_line("29 host-api", t0, "float64 card against CPU (flags equal, rtol 1e-5 + atol "
               "1e-7, nfev within 2; max rel): %s; GMixND %d rows, %d gaussians %s %d "
               "samples, %.3f ms (profiling.timed), max rel %.2e; gaussap %d bdf objects x 3 "
               "bands %.3f s, %d flagged, max rel %.2e; K3 %d, K2 %d launches; total %.1f s"
               % (", ".join("%s %d %s (%.1e)" % (g, API_N.get(g, 1), API_ROUTE[g], w)
                            for g, w in worst.items()), GMIXND_ROWS, GMIXND_NGAUSS,
                  "fit to" if sup["fitted"] else "(sklearn absent: the drawing mixture) of",
                  GMIXND_SAMPLES, 1e3 * gmixnd_s, rel["GMixND"], GAP_OBJECTS, gap_s,
                  int((~ok).any(1).sum()), rel["gaussap"], k3, k2,
                  time.perf_counter() - t_all))
    return dict(k3_launches=k3, k2_launches=k2)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr, flush=True)
        return 2
    device = "cuda"
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase_line("1 card", t0, "%s, %d device(s)" % (kind, torch.cuda.device_count()))

    # the build runs beside the card sides of phases 3-17 (whose time it
    # hides: nvcc keeps every core); the CPU sides start when its last
    # source has started (LateCpuSide)
    build = _build.start(first=EARLY_UNITS)
    warm_run_lm(device)
    cpu_side = LateCpuSide(device, build)
    try:
        return phases(device, t_all, kind, cpu_side)
    finally:
        cpu_side.close()


class LateCpuSide:
    """the CpuSide of the run, started once the build's last source has
    started, as cores free up (its workers beside every nvcc slow the
    build more than they gain): the checks of phases 5, 9, 15 and 17
    that read it are deferred (defer) and run, in their order, right
    after the build's line (start, or the first get)"""

    def __init__(self, device, build):
        self.device, self.build = device, build
        self.side, self.deferred = None, []

    def defer(self, fn):
        self.deferred.append(fn)

    def start(self):
        if self.side is None:
            if self.build is not None:
                self.build.launched.wait()
            self.side = start_cpu_side(self.device)
            build_line(self.build)
            while self.deferred:
                self.deferred.pop(0)()

    def get(self, key):
        self.start()
        return self.side.get(key)

    def __getattr__(self, name):
        if name.startswith("_") or self.side is None:
            raise AttributeError(name)
        return getattr(self.side, name)

    def close(self):
        if self.side is not None:
            self.side.close()


# the sources of the kernels that phases 3-18 launch, built first
EARLY_UNITS = ("gmix_eval", "normal_eqs", "lm_solve", "lm_solve_mb_exp")
BUILD_SECONDS = {}


def build_line(build):
    """phase 2's line once the build started by main has ended (None: the
    libraries were there): its wall seconds and each unit's nvcc CPU
    seconds"""
    t0 = time.perf_counter()
    if build is None:
        phase_line("2 build", t0, "%s: every source's library was built before"
                   % _build.library_path().relative_to(_build.BUILD_DIR.parents[1]))
        return
    path = build.wait()
    BUILD_SECONDS["wall"] = build.seconds
    units = sorted(_build.UNIT_SECONDS.items(), key=lambda x: -x[1])
    phase_line("2 build", t0, "%s, %d units, %d at a time beside phases 3-17 (%s first, then "
               "the costliest); wall %.1f s, nvcc CPU %.1f s (unit CPU s [wall from-to]: %s)"
               % (path.relative_to(path.parents[2]), len(_build.sources()), build.slots,
                  ", ".join(EARLY_UNITS), build.seconds, sum(_build.UNIT_SECONDS.values()),
                  ", ".join("%s %.1f [%.0f-%.0f]" % (k[:-3], v, *build.span[k[:-3]])
                            for k, v in units)))


def warm_run_lm(device):
    """the residual LM (no kernel of ours) once on a small linear problem
    on device: the one-time start-up of its first fit on the card (the
    Jacobian's torch.func transforms and the factorization, seconds)
    then runs while nvcc does, not in phase 27's first run_lm fit"""
    A = torch.linspace(-1.0, 1.0, 12, dtype=torch.float64, device=device).reshape(6, 2)
    y = A @ torch.tensor([0.5, -1.0], dtype=torch.float64, device=device)
    inf = torch.full((2,), torch.inf, dtype=torch.float64, device=device)
    tlm.run_lm(lambda p, d: d[0] @ p - d[1], (A, y), torch.zeros_like(inf), -inf, inf,
               tlm.LMConf())


def phases(device, t_all, kind, cpu_side):
    """phases 3-29 and the kernels line, with the CPU sides of phases 5,
    9, 15, 17-24 and 26-29 from cpu_side (a LateCpuSide: the checks of
    phases 5, 9, 15 and 17 run with phase 2's line after phase 17's card
    side)"""
    t0 = time.perf_counter()
    max_abs, ncase, worst = check_kernel(device)
    indep = check_k2_batch_independence(device)
    phase_line("3 kernel", t0, "%d cases agree; max abs err %.3e; max rel err "
               "f32 %.3e f64 %.3e; bitwise on %d permuted lanes"
               % (ncase, max_abs, worst[torch.float32], worst[torch.float64], indep))

    t0 = time.perf_counter()
    gmix_eval.launches = 0
    mp, hom = run_main(device, B_MAIN)
    launches = gmix_eval.launches
    limit = max(8, int(0.005 * B_MAIN))
    phase_line(
        "4 main", t0,
        "B=%d m=%.3e hetero_m=%.3e R11=%.4f flagged=%d hetero_flagged=%d "
        "k2_launches=%d stamps/s=%.1f (median %.4f s/call of 3, range "
        "%.4f-%.4f)"
        % (B_MAIN, mp["m"], mp["het_m"], mp["R11"], mp["flagged"],
           mp["het_flagged"], launches, mp["stamps_per_s"], mp["sec"],
           *mp["sec_range"]),
    )
    if launches <= 0:
        raise SmokeFailure("the main path did not launch K2")
    if not (abs(mp["m"]) < 1e-3 and abs(mp["het_m"]) < 1e-3):
        raise SmokeFailure("m gate failed: m=%.3e hetero m=%.3e"
                           % (mp["m"], mp["het_m"]))
    if mp["flagged"] > limit or mp["het_flagged"] > limit:
        raise SmokeFailure("too many flagged lanes: %d, %d > %d"
                           % (mp["flagged"], mp["het_flagged"], limit))

    cpu_side.defer(lambda: gaussmom_card_cpu(cpu_side))
    del hom

    t0 = time.perf_counter()
    rows = [time_k2(name, *x, fast=False) for name, x in main_path_shapes(device, B_MAIN).items()]
    phase_line("6 times", t0, "%s; total %.1f s" % ("; ".join(k2_row_text(r).strip() for r in rows),
                                                    time.perf_counter() - t_all))

    t0 = time.perf_counter()
    k1_abs, k1_ncase, k1_worst = check_k1(device)
    phase_line("7 k1", t0, "%d cases agree; max abs err %.3e; max err relative to "
               "|value| + scale f32 %.3e f64 %.3e"
               % (k1_ncase, k1_abs, k1_worst[torch.float32], k1_worst[torch.float64]))

    t0 = time.perf_counter()
    lp, hom, het, res_k3 = run_exp_lm(device, B_MAIN)
    k3_launches = lp["launches"]["k3"]
    k2_lm_launches = lp["launches"]["k2"]
    phase_line(
        "8 exp-lm", t0,
        "B=%d m=%.3e hetero_m=%.3e R11=%.4f flagged=%d hetero_flagged=%d frozen=%.4f "
        "launches of the hom and het calls: k3=%d k1=%d k2=%d; both selection estimators "
        "(s2n > -1): R_sel 0, shear within rtol 1e-10 of shear_response's (max rel %.3e); "
        "nfev (mean, p50, p99, max): hom %s het %s"
        % (B_MAIN, lp["m"], lp["het_m"], lp["R11"], lp["flagged"], lp["het_flagged"],
           lp["frozen"], k3_launches, lp["launches"]["k1"], k2_lm_launches, lp["select"],
           *("(%.3f, %g, %g, %d)" % x for x in lp["nfev"])),
    )
    if k3_launches <= 0 or k2_lm_launches <= 0:
        raise SmokeFailure("the exp-LM path did not launch K3 and K2: %d, %d"
                           % (k3_launches, k2_lm_launches))
    check_gate(lp, B_MAIN, "exp-LM")

    cpu_side.defer(lambda: compare_lm_card_cpu(cpu_side))

    t0 = time.perf_counter()
    lv_cascade, lv_flat = check_compaction(hom, device)
    phase_line("10 compact", t0, "B=%d: cascade %s and no compaction %s bitwise equal"
               % (B_COMPACT, lv_cascade, lv_flat))

    t0 = time.perf_counter()
    lm_rows = time_lm_kernels(hom, device)
    for r in lm_rows:
        print("    %s %s: agrees (max abs err %.3e, rel %.3e); %.4f ms, plain "
              "%.4f ms, bound %.4f ms (%s)%s"
              % (r["kernel"], r["shape"], r["max_abs_err"], r["max_rel_err"], r["ms"],
                 r["plain_ms"], r["bound_ms"], r["bound_by"],
                 "; %s, grid %d, tile %d" % (attrs_text(r), r["grid"], r["tile"])
                 if r["kernel"] == "K2" else ""), flush=True)
    fit_p = LM_CONF.fit_dims[0] * LM_CONF.fit_dims[1]
    k3_attrs = lm_solve.kernel_attrs(torch.float32, fit_p)
    phase_line("11 k-times", t0, "K3 float32 at %d pixels a lane: %s; total %.1f s"
               % (fit_p, attrs_text(k3_attrs), time.perf_counter() - t_all))

    t0 = time.perf_counter()
    k3c = check_k3(device, hom)
    phase_line(
        "12 k3", t0,
        "float64 B=%d: routes agree (max rel %.3e, max nfev diff %d); K3 and its plain "
        "version agree (max abs %.3e, rel %.3e, nfev diff %d); bounded B=%d (%d lanes "
        "pinned) agrees with run_lm_normal_batched (max rel %.3e, nfev diff %d); P=2401 "
        "(planes in global memory), 64 lanes: K3 and its plain version agree (max rel "
        "%.3e, nfev diff %d), float32 %s: %.4f ms, plain %.4f ms, bound %.4f ms (%s), "
        "within %.3e pars_err"
        % (B_COMPACT, *k3c["routes64"], *k3c["plain64"], B_BOUNDED, k3c["pinned"],
           k3c["bounded"][1], k3c["bounded"][2], k3c["full64"][1], k3c["full64"][2],
           k3c["full32"]["shape"], k3c["full32"]["ms"], k3c["full32"]["plain_ms"],
           k3c["full32"]["bound_ms"], k3c["full32"]["bound_by"], k3c["full32"]["max_in_err"]))

    t0 = time.perf_counter()
    k3_row, calls, host = time_k3(device, hom, het, res_k3)
    del hom, het, res_k3
    hg, hl = host["gate"], host["launches"]
    print("    host-loop route B=%d: m=%.3e hetero_m=%.3e flagged=%d hetero_flagged=%d, "
          "launches of its hom and het calls: k3=%d k1=%d k2=%d; float32 lanes outside "
          "rtol 1e-4 of the K3 route: %.4f, largest difference %.3e pars_err"
          % (B_MAIN, hg["m"], hg["het_m"], hg["flagged"], hg["het_flagged"], hl["k3"],
             hl["k1"], hl["k2"], *host["split32"]), flush=True)
    check_gate(hg, B_MAIN, "host-loop exp-LM")
    if hl["k1"] <= 0:
        raise SmokeFailure("the host-loop route did not launch K1")
    print("    K3 %s: %.4f ms, plain %.4f ms, bound %.4f ms (%s), sum nfev %d; against its "
          "plain version flags equal on every lane, %.4f outside rtol 1e-4, largest "
          "difference %.3e pars_err (max abs %.3e); bitwise on %d permuted lanes"
          % (k3_row["shape"], k3_row["ms"], k3_row["plain_ms"], k3_row["bound_ms"],
             k3_row["bound_by"], k3_row["nfev_sum"], k3_row["split"],
             k3_row["max_in_err"], k3_row["max_abs_err"], k3_row["indep"]), flush=True)
    print("    " + "; ".join(
        "exp-LM call, %s route: %.1f stamps/s (median %.4f s of %d, range %.4f-%.4f), event "
        "span %.3f ms" % (r, c["stamps_per_s"], c["sec"], N_TIMED, *c["sec_range"], c["span_ms"])
        for r, c in calls.items()), flush=True)
    phase_line("13 k3-times", t0, "total %.1f s" % (time.perf_counter() - t_all))

    admom_launches, admom_rows, modes = admom_phases(device, t_all, cpu_side)
    cpu_side.start()
    k3mb_row, mb_k2_rows, mb_launches, mb_args = mb_phase(device, t_all, cpu_side)
    prepsf_row, prepsf = prepsf_phase(device, t_all, cpu_side)
    em_phase(device, t_all, cpu_side)
    models = models_phase(device, t_all, mb_args, cpu_side)
    comp = composite_phase(device, t_all, cpu_side)
    pri = prior_phase(device, t_all, cpu_side)
    opt = options_phase(device, t_all, cpu_side)
    scaleout_phase(device, t_all)
    hst = host_phase(device, t_all, cpu_side)
    fit = fitter_phase(device, t_all, cpu_side)
    boot = bootstrap_phase(device, t_all, cpu_side)
    api = host_api_phase(device, t_all, cpu_side)
    prepsf_launches = {k: g["launches"] for k, g in prepsf.items() if "dilate" not in k}

    top = rows[0]
    k1_row = lm_rows[0]
    k2_modes = {"%s %s" % (r["measure"], r["mode"]): r["launches"]["k2"] for r in modes}
    print(json.dumps({"kernels": [{
        "name": "gmix_eval",
        "route": "cuda",
        "source": "ngmix_tpu_torch/csrc/gmix_eval.cu",
        "replaces": "ngmix_tpu/ops/pallas_gmix.py:88",
        "launches": (launches + k2_lm_launches + admom_launches + sum(k2_modes.values())
                     + mb_launches["k2"] + sum(prepsf_launches.values())
                     + sum(models["k2_launches"].values()) + sum(comp["k2_launches"].values())
                     + sum(pri["k2_launches"].values()) + sum(opt["k2_launches"].values())
                     + sum(hst["k2_launches"].values()) + fit["k2_launches"]
                     + boot["k2_launches"] + api["k2_launches"]),
        "launches_by_path": dict({"gaussmom": launches, "exp-lm": k2_lm_launches,
                                  "admom": admom_launches, "mb exp-lm": mb_launches["k2"]},
                                 **k2_modes, **prepsf_launches, **models["k2_launches"],
                                 **comp["k2_launches"], **pri["k2_launches"],
                                 **opt["k2_launches"], **hst["k2_launches"],
                                 **{"host Fitter": fit["k2_launches"],
                                    "host metacal bootstrap": boot["k2_launches"],
                                    "host API": api["k2_launches"]}),
        "max_abs_err": max(max_abs, *(r["max_abs_err"] for r in rows + admom_rows + mb_k2_rows
                                      + [prepsf_row, models["k2_row"], comp["k2_row"]]
                                      + hst["k2_rows"]),
                           lm_rows[1]["max_abs_err"]),
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "attrs": {k: top[k] for k in ("regs", "static_smem", "dynamic_smem",
                                      "blocks_per_sm")},
        "shapes": rows + [lm_rows[1]] + admom_rows + mb_k2_rows + [prepsf_row, models["k2_row"],
                                                                   comp["k2_row"]]
        + hst["k2_rows"],
    }, {
        "name": "normal_eqs",
        "route": "cuda",
        "source": "ngmix_tpu_torch/csrc/normal_eqs.cu",
        "replaces": "ngmix_tpu/ops/pallas_lm.py:149",
        # the exp-LM path runs through K3; K1 runs on its host-loop route
        "launches": hl["k1"],
        "launches_by_path": {"exp-lm": lp["launches"]["k1"], "exp-lm host loop": hl["k1"]},
        "max_abs_err": max(k1_abs, k1_row["max_abs_err"]),
        "ms": k1_row["ms"],
        "plain_ms": k1_row["plain_ms"],
        "bound_ms": k1_row["bound_ms"],
        "bound_by": k1_row["bound_by"],
        "library_ms": None,
        "shapes": [k1_row],
    }, {
        "name": "lm_solve",
        "route": "cuda",
        "source": "ngmix_tpu_torch/csrc/lm_solve.cuh",
        "replaces": "ngmix_tpu/ops/pallas_lm.py:149",
        "replaces_loop": "ngmix_tpu/fitting/lm.py:539-790",
        "launches": (k3_launches + modes[-1]["launches"]["k3"]
                     + sum(models["k3_launches"].values()) + sum(comp["k3_launches"].values())
                     + sum(pri["k3_launches"].values()) + sum(opt["k3_launches"].values())
                     + fit["k3_launches"] + boot["k3_launches"] + api["k3_launches"]),
        "launches_by_path": dict({"exp-lm": k3_launches, "exp-lm host loop": hl["k3"],
                                  "exp-lm dilate": modes[-1]["launches"]["k3"]},
                                 **models["k3_launches"], **comp["k3_launches"],
                                 **pri["k3_launches"], **opt["k3_launches"],
                                 **{"host Fitter": fit["k3_launches"],
                                    "host metacal bootstrap": boot["k3_launches"],
                                    "host API": api["k3_launches"]}),
        "max_abs_err": max(k3c["plain64"][0], k3c["full64"][0], k3_row["max_abs_err"],
                           k3c["full32"]["max_abs_err"], models["max_abs_err"],
                           comp["max_abs_err"], pri["max_abs_err"],
                           fit["rows"][0]["max_abs_err"]),
        "ms": k3_row["ms"],
        "plain_ms": k3_row["plain_ms"],
        "bound_ms": k3_row["bound_ms"],
        "bound_by": k3_row["bound_by"],
        "library_ms": None,
        "attrs": k3_attrs,
        "shapes": [k3_row, k3c["full32"]] + models["k3_rows"] + comp["k3_rows"]
        + pri["k3_rows"] + fit["rows"][:1],
        "exp_lm_calls": calls,
    }, {
        "name": "lm_solve_mb",
        "route": "cuda",
        "source": "ngmix_tpu_torch/csrc/lm_solve_mb.cuh",
        "replaces": "ngmix_tpu/ops/pallas_lm.py:149",
        "replaces_loop": "ngmix_tpu/fitting/lm.py:539-790 under ngmix_tpu/batch.py:1795-1866",
        "launches": (mb_launches["k3mb"] + sum(models["k3mb_launches"].values())
                     + sum(comp["k3mb_launches"].values())
                     + sum(pri["k3mb_launches"].values()) + fit["k3mb_launches"]),
        "launches_by_path": dict({"mb exp-lm": mb_launches["k3mb"]},
                                 **models["k3mb_launches"], **comp["k3mb_launches"],
                                 **pri["k3mb_launches"],
                                 **{"host Fitter": fit["k3mb_launches"]}),
        "max_abs_err": max(k3mb_row["max_abs_err"], models["mb_max_abs_err"],
                           comp["mb_max_abs_err"], pri["mb_max_abs_err"],
                           fit["rows"][1]["max_abs_err"]),
        "ms": k3mb_row["ms"],
        "plain_ms": k3mb_row["plain_ms"],
        "bound_ms": k3mb_row["bound_ms"],
        "bound_by": k3mb_row["bound_by"],
        "library_ms": None,
        "attrs": k3mb_row.pop("attrs"),
        "shapes": [k3mb_row] + models["k3mb_rows"] + comp["k3mb_rows"] + pri["k3mb_rows"]
        + fit["rows"][1:],
    }] + [{
        "name": "lm_solve_" + mode,
        "route": "cuda",
        "source": "ngmix_tpu_torch/csrc/lm_solve_opt.cuh",
        "replaces": "ngmix_tpu/ops/pallas_lm.py:149",
        "replaces_loop": loop,
        "launches": sum(opt[mode + "_launches"].values()),
        "launches_by_path": opt[mode + "_launches"],
        "max_abs_err": opt[mode + "_max_abs_err"],
        "ms": opt[mode + "_rows"][0]["ms"],
        "plain_ms": opt[mode + "_rows"][0]["plain_ms"],
        "bound_ms": opt[mode + "_rows"][0]["bound_ms"],
        "bound_by": opt[mode + "_rows"][0]["bound_by"],
        "library_ms": None,
        "attrs": opt[mode + "_rows"][0]["attrs"],
        "shapes": opt[mode + "_rows"],
    } for mode, loop in (("refine", "ngmix_tpu/fitting/lm.py:903-976"),
                         ("varpro", "ngmix_tpu/batch.py:831-871"))]}, allow_nan=False),
        flush=True)
    print(timing_line(t_all), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print("chip_smoke FAILED: %s" % exc, flush=True)
        sys.exit(1)
