"""The face-swap loops of the port against the JAX package's: the linear beta
schedule, the SDE inversion on JAX's own q-sampling draws, ``h_edit_r_face``
and ``ef_face`` on the tiny DDPM with seeded differentiable toy losses (one
image a JAX run, two images a port run), and ``main_face`` on the CPU with
the tiny models against the port's library calls.

Tolerances (float32): the inversion's residuals within 1e-4 of their largest
value (a residual divides eps's float32 difference by c1 = 0.5 sqrt(1 -
abar_{t-1}), 5e-3 at the last step); the loops' outputs within 1e-4 of
max|x|, and without a loss the reconstruction identities within 1e-4 (the
inversion's 4-row and the loop's 2-row UNet calls round differently on the
CPU, and a residual carries that times 1 / c1, 200 at the last step;
measured 2.7e-5).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hedit_tpu.core import schedule as j_schedule
from hedit_tpu.edit import face_swap as j_face_swap
from hedit_tpu.invert import sde as j_sde
from hedit_tpu.models import ddpm_unet as j_ddpm
from hedit_tpu_torch.cli import main_face
from hedit_tpu_torch.core import schedule
from hedit_tpu_torch.edit.face_swap import ef_face, h_edit_r_face
from hedit_tpu_torch.invert.sde import face_step_coeffs, invert_sde
from hedit_tpu_torch.io_utils import weights
from hedit_tpu_torch.models import ddpm_unet
from hedit_tpu_torch.pipelines.sd import seeded_init_

S = 5
LINEAR = dict(beta_schedule="linear", beta_start=1e-4, beta_end=2e-2, steps_offset=1)


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny():
    """The tiny DDPM at the port's seeded weights and the same weights in JAX
    (``convert_ddpm_ckpt``); the face grid of S steps in both packages; two
    seeded 16x16 images and JAX's seed-42 inversion of each (JAX draws its
    own q-samples; the port takes them as ready ``xts``)."""
    model = ddpm_unet.DDPMUNet(ddpm_unet.DDPMConfig.tiny())
    seeded_init_(model, torch.Generator().manual_seed(0))
    model.eval().requires_grad_(False)
    params = jax.tree_util.tree_map(jnp.asarray, j_ddpm.convert_ddpm_ckpt(
        {k: v.numpy() for k, v in model.state_dict().items()}))
    jmodel = j_ddpm.DDPMUNet(j_ddpm.DDPMConfig.tiny())
    sched = schedule.Schedule.create(S, **LINEAR)
    jsched = j_schedule.Schedule.create(S, **LINEAR)
    rs = np.random.RandomState(0)
    x0 = rs.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)

    @jax.jit
    def invert(p, x, key):
        return j_sde.invert_sde(lambda xx, tt: jmodel.apply(p, xx, tt), jsched, x, eta=1.0,
                                rng=key, step_chunk=4)

    invs = [invert(params, jnp.asarray(x0[b:b + 1]), jax.random.PRNGKey(42 + b))
            for b in range(2)]
    return dict(model=model, params=params, jmodel=jmodel, sched=sched, jsched=jsched,
                x0=x0, invs=invs)


def test_linear_schedule_matches_jax():
    """``Schedule.create`` with every beta schedule of ``make_beta_schedule``
    (the face pipeline's ``linear`` 1e-4 -> 2e-2 at offset 1 among them) and
    with a given grid: the tables and the grid bit for bit as JAX's; the
    eta = 0.5 split's coefficients at every step of the 100-step face grid
    within one float32 ulp (XLA:CPU's float32 sqrt is one ulp off the
    correctly rounded one at some inputs)."""
    for kind in ("scaled_linear", "linear", "quad", "const", "jsd", "sigmoid"):
        for steps, kw in ((100, dict(beta_start=1e-4, beta_end=2e-2)), (50, {})):
            got = schedule.Schedule.create(steps, beta_schedule=kind, **kw)
            want = j_schedule.Schedule.create(steps, beta_schedule=kind, **kw)
            np.testing.assert_array_equal(got.alphas_cumprod.numpy(),
                                          np.asarray(want.alphas_cumprod))
            np.testing.assert_array_equal(got.timesteps.numpy(), np.asarray(want.timesteps))
            assert float(got.final_alpha_cumprod) == float(want.final_alpha_cumprod)
    grid = np.array([900, 500, 100, 3])
    np.testing.assert_array_equal(
        schedule.Schedule.create(4, timesteps=grid).timesteps.numpy(),
        np.asarray(j_schedule.Schedule.create(4, timesteps=grid).timesteps))
    with pytest.raises(ValueError):
        schedule.make_beta_schedule("cosine", 10, 1e-4, 2e-2)
    got = schedule.Schedule.create(100, **LINEAR)
    want = j_schedule.Schedule.create(100, **LINEAR)
    ts = got.timesteps
    tm1 = torch.cat([ts[1:], torch.zeros(1, dtype=ts.dtype)])
    jts = want.timesteps
    jtm1 = jnp.concatenate([jts[1:], jnp.zeros((1,), jts.dtype)])
    for a, b in zip(face_step_coeffs(got, ts, tm1), j_sde.face_step_coeffs(want, jts, jtm1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2.0 ** -23, atol=0)


def test_invert_sde_matches_jax(tiny):
    """On JAX's draws (``xts=``, two images at once, 4 steps a UNet call, so
    the last call has 1 row): the residuals within 1e-4 of their largest,
    ``xT`` = xts[:, S].  The port's own draws: xts[:, 0] = x0, and two images
    from two seed-42 generators each their one-image run bit for bit."""
    model, sched, invs = tiny["model"], tiny["sched"], tiny["invs"]
    xts = torch.from_numpy(np.stack([np.asarray(inv.xts) for inv in invs]))
    got = invert_sde(model, sched, xts=xts, step_chunk=4)
    for b, inv in enumerate(invs):
        want = np.asarray(inv.zs)
        assert got.zs[b].shape == want.shape == (S, 16, 16, 3)
        assert np.abs(got.zs[b].numpy() - want).max() <= 1e-4 * np.abs(want).max()
    assert torch.equal(got.xT, xts[:, S]) and got.noise_added is None

    x0 = torch.from_numpy(tiny["x0"])
    both = invert_sde(model, sched, x0, generator=[torch.Generator().manual_seed(42)
                                                   for _ in range(2)], step_chunk=4)
    assert torch.equal(both.xts[:, 0], x0) and both.noise_added.shape == (2, S + 1, 16, 16, 3)
    for b in range(2):
        one = invert_sde(model, sched, x0[b:b + 1], generator=torch.Generator().manual_seed(42),
                         step_chunk=4)
        assert torch.equal(one.xts[0], both.xts[b]) and torch.equal(one.zs[0], both.zs[b])


def _toy_losses(rs, src):
    """Seeded differentiable stand-ins for the critics, in both frameworks:
    an identity loss 1 - cos(tanh(x W), e_ref) and a perceptual one
    mean(w (x - src)^2), each summed over the batch in the port."""
    w_id = rs.randn(16 * 16 * 3, 8).astype(np.float32) * 0.05
    e_ref = rs.randn(8).astype(np.float32)
    w_lp = rs.uniform(0.5, 1.5, (16, 16, 3)).astype(np.float32)

    def j_id(x):
        e = jnp.tanh(x.reshape(x.shape[0], -1) @ w_id)
        return jnp.mean(1 - e @ e_ref / (jnp.linalg.norm(e, axis=-1) * np.linalg.norm(e_ref)))

    def j_lp(x, src):
        return jnp.mean(w_lp * (x - src) ** 2)

    tw_id, te_ref, tw_lp = (torch.from_numpy(a) for a in (w_id, e_ref, w_lp))

    def t_id(x):
        e = torch.tanh(x.reshape(x.shape[0], -1) @ tw_id)
        return (1 - e @ te_ref / (torch.linalg.vector_norm(e, dim=-1)
                                  * torch.linalg.vector_norm(te_ref))).sum()

    def t_lp(x):
        return (tw_lp * (x - src) ** 2).mean(dim=(1, 2, 3)).sum()

    return j_id, j_lp, t_id, t_lp


def test_face_loops_match_jax(tiny):
    """``h_edit_r_face`` (K = 2) and ``ef_face`` on JAX's trajectories of two
    images, each loop run once on both images in the port and once an image
    in JAX, with both toy losses, a seeded soft face mask, weights 50 / 100
    and N = S - 1 steps after a skip: within 1e-4 of max|x|.  Without a loss
    h-Edit-R returns xts[:, 0] and EF xts[:, 1] (its last step dropped, as
    the reference breaks) within 1e-4 of max|x|.  Then h-Edit-R with the real
    critics (``_real_critics_match_jax``)."""
    model, params, jmodel = tiny["model"], tiny["params"], tiny["jmodel"]
    sched, jsched, invs = tiny["sched"], tiny["jsched"], tiny["invs"]
    rs = np.random.RandomState(1)
    src = tiny["x0"]
    mask = rs.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)
    j_id, j_lp, t_id, t_lp = _toy_losses(rs, torch.from_numpy(src))
    xts = torch.from_numpy(np.stack([np.asarray(inv.xts) for inv in invs]))
    zs = torch.from_numpy(np.stack([np.asarray(inv.zs) for inv in invs]))
    N = S - 1

    def j_run(mode, p, xT, zs_, src_, mask_):
        eps = lambda xx, tt: jmodel.apply(p, xx, tt)  # noqa: E731
        common = dict(id_loss_fn=j_id, lpips_loss_fn=lambda x: j_lp(x, src_),
                      after_skip_steps=N, soft_face_mask=mask_)
        if mode == "h_edit_R":
            return j_face_swap.h_edit_r_face(eps, jsched, xT, zs_, weight_edit_face=50.0,
                                             optimization_steps=2, **common)
        return j_face_swap.ef_face(eps, jsched, xT, zs_, weight_edit_face=100.0, **common)

    j_run = jax.jit(j_run, static_argnums=0)
    for mode in ("h_edit_R", "ef"):
        common = dict(id_loss_fn=t_id, lpips_loss_fn=t_lp, after_skip_steps=N,
                      soft_face_mask=torch.from_numpy(mask))
        if mode == "h_edit_R":
            got = h_edit_r_face(model, sched, xts[:, N], zs, weight_edit_face=50.0,
                                optimization_steps=2, **common)
        else:
            got = ef_face(model, sched, xts[:, N], zs, weight_edit_face=100.0, **common)
        for b, inv in enumerate(invs):
            want = np.asarray(j_run(mode, params, inv.xts[N][None], inv.zs,
                                    jnp.asarray(src[b:b + 1]), jnp.asarray(mask[b:b + 1])))
            scale = np.abs(want).max()
            err = np.abs(got[b:b + 1].numpy() - want).max()
            assert err <= 1e-4 * scale, (mode, b, err, scale)
            assert np.abs(want - np.asarray(inv.xts[0])).max() > 1e-2 * scale  # the losses move it

    _real_critics_match_jax()

    scale = xts.abs().max()
    recon = h_edit_r_face(model, sched, xts[:, S], zs, after_skip_steps=S)
    assert (recon - xts[:, 0]).abs().max() <= 1e-4 * scale
    recon = ef_face(model, sched, xts[:, S], zs, after_skip_steps=S)
    assert (recon - xts[:, 1]).abs().max() <= 1e-4 * scale


def _real_critics_match_jax():
    """h-Edit-R with the real critics (``create_face_pipeline(tiny=True)``'s
    seeded IR-SE-50 and LPIPS-VGG, the pipeline's own loss closures) against
    JAX's loop with its ``cosine_loss`` and LPIPS mean on the same weights,
    3 steps, K = 1, weight 100 (the CLI's at K = 1), on JAX's trajectory: the
    critics move the edit by more than half of max|x|, and the two edits
    agree within 5% of that move.  The critics' float32 gradients are
    ill-conditioned at seeded weights (``test_critic_gradients_match_jax``),
    and weight 100 carries that: measured 2.7% (1.2% at weight 10, 0.4% at
    1), the JAX scan's compile ~14 s."""
    from hedit_tpu.models import arcface as j_arcface
    from hedit_tpu.models import lpips_vgg as j_lpips
    from hedit_tpu_torch.pipelines.face import create_face_pipeline

    steps = 3
    pipe = create_face_pipeline(tiny=True, num_inference_steps=steps, seed=3, device="cpu")

    def to_jax(convert, model):
        return jax.tree_util.tree_map(jnp.asarray, convert(
            {k: v.numpy() for k, v in model.state_dict().items()}))

    p_unet, p_arc, p_lp = (to_jax(j_ddpm.convert_ddpm_ckpt, pipe.unet),
                           to_jax(j_arcface.convert_irse50, pipe.arcface),
                           to_jax(j_lpips.convert_lpips_vgg, pipe.lpips))
    jmodel, jarc, jlp = (j_ddpm.DDPMUNet(j_ddpm.DDPMConfig.tiny()), j_arcface.IRSE50(),
                         j_lpips.LPIPSVgg())
    jsched = j_schedule.Schedule.create(steps, **LINEAR)
    rs = np.random.RandomState(4)
    ref, src = (rs.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32) for _ in range(2))
    inv = jax.jit(lambda p, x, key: j_sde.invert_sde(
        lambda xx, tt: jmodel.apply(p, xx, tt), jsched, x, rng=key, step_chunk=10))(
            p_unet, jnp.asarray(src), jax.random.PRNGKey(42))
    ref_embed = jax.jit(lambda p, x: j_arcface.extract_feats(p, jarc, x))(p_arc, jnp.asarray(ref))

    @jax.jit
    def j_run(pu, pa, pl, xT, zs_, ref_embed_, src_):
        return j_face_swap.h_edit_r_face(
            lambda xx, tt: jmodel.apply(pu, xx, tt), jsched, xT, zs_,
            id_loss_fn=lambda img: j_arcface.cosine_loss(pa, jarc, img, ref_embed_),
            lpips_loss_fn=lambda img: jnp.mean(jlp.apply(pl, img, src_)),
            weight_edit_face=100.0, optimization_steps=1, after_skip_steps=steps)

    want = np.asarray(j_run(p_unet, p_arc, p_lp, inv.xts[steps][None], inv.zs, ref_embed,
                            jnp.asarray(src)))
    xts = torch.from_numpy(np.asarray(inv.xts))[None]
    got = h_edit_r_face(pipe.unet, pipe.schedule, xts[:, steps],
                        torch.from_numpy(np.asarray(inv.zs))[None],
                        id_loss_fn=pipe.id_loss_fn(torch.from_numpy(ref)),
                        lpips_loss_fn=pipe.lpips_loss_fn(torch.from_numpy(src)),
                        weight_edit_face=100.0, optimization_steps=1,
                        after_skip_steps=steps).numpy()
    moved = np.abs(want - np.asarray(inv.xts[0])).max()
    assert moved > 0.5 * np.abs(want).max()
    assert np.abs(got - want).max() <= 0.05 * moved, (np.abs(got - want).max(), moved)


def _write_checkpoints(tmp_path):
    """Checkpoint files of the tiny DDPM and the critics at seeded weights,
    in the reference files' layouts: the CelebA checkpoint a list of one
    DataParallel state dict with a ``logvar``; ArcFace with BatchNorm's
    ``num_batches_tracked``; the lpips weights with torchvision's
    ``net.features.N`` keys, ``lins.N`` and the scaling layer's buffers; the
    parser's under a ``state_dict`` entry.  Each state dict is the inverse
    of the JAX converter applied to that converter's own output."""
    from hedit_tpu.models import arcface as j_arcface
    from hedit_tpu.models import face_parser as j_parser
    from hedit_tpu.models import lpips_vgg as j_lpips
    from hedit_tpu_torch.models import arcface, face_parser, lpips_vgg

    paths = {}
    for i, (name, make, convert, inverse) in enumerate((
            ("celeba", lambda: ddpm_unet.DDPMUNet(ddpm_unet.DDPMConfig.tiny()),
             j_ddpm.convert_ddpm_ckpt, weights.ddpm_state_dict),
            ("arcface", arcface.IRSE50, j_arcface.convert_irse50, weights.irse50_state_dict),
            ("lpips", lpips_vgg.LPIPSVgg, j_lpips.convert_lpips_vgg,
             weights.lpips_vgg_state_dict),
            ("parser", face_parser.FaceParsing, j_parser.convert_face_parser,
             weights.face_parser_state_dict))):
        model = make()
        seeded_init_(model, torch.Generator().manual_seed(100 + i))
        sd = inverse(convert({k: v.numpy() for k, v in model.state_dict().items()}), model)
        if name == "celeba":
            obj = [dict({"module." + k: v for k, v in sd.items()}, logvar=torch.zeros(1000))]
        elif name == "arcface":
            obj = dict(sd, **{k.replace("running_mean", "num_batches_tracked"): torch.tensor(7)
                              for k in sd if k.endswith("running_mean")})
        elif name == "lpips":
            obj = {(k.replace("lin", "lins.") if k.startswith("lin")
                    else k.replace(k.split(".")[1], "features")): v for k, v in sd.items()}
            obj["scaling_layer.shift"] = torch.zeros(1, 3, 1, 1)
        else:
            obj = {"state_dict": sd}
        paths[name] = str(tmp_path / f"{name}.pth")
        torch.save(obj, paths[name])
    return paths


def test_main_face_cli(tmp_path, capsys):
    """``main_face --tiny --device cpu`` on two seeded PNGs with checkpoint
    files (``_write_checkpoints``), 3 steps, K = 1 (so weight 100):

    * h_edit_R on (a, b): ``item_a_b.png`` against the port's library calls
      (``create_face_pipeline`` on the same files, ``invert_sde`` from a
      seed-42 generator, ``h_edit_r_face`` on the pipeline's losses, the
      parser's mask blend, ``image_grid`` of [ref, source, edited]) within 3
      of 255 levels at no more than 15% of the values, and the printed cosine
      similarity within 1e-5.  Alone in a process the two are bit for bit the
      same; after this file's JAX runs the CPU convolutions round some sums
      otherwise (measured: 6% of the values 1-2 levels apart), and the seeded
      critics at weight 100 amplify any rounding (``test_critic_gradients_match_jax``).
      Without the mask blend the image differs;
    * ``--data_parallel 2`` over a data file of (a, b) and (b, a): each output
      bit for bit the pair's row of one batched library call
      (``main_face.edit_pairs`` and ``finish_pair``); ``--resume`` then skips
      both.  The batched call gives each pair its one-pair result: in
      float64 within 1e-6 (measured 4e-9: the DDPM's GroupNorm statistics
      and attention scores stay float32, as JAX's do, and a batch of two
      rounds them otherwise; with the identity loss a mean over the batch in
      place of the sum, each gradient halved, the pair misses by 0.79).  In float32 the CPU
      convolutions round a batch of two otherwise too, and the seeded
      critics' kinks amplify that to a few percent in a few steps
      (``test_critic_gradients_match_jax``).
    * ef with ``--save_trajectory``, then ``--load_trajectory``: the same image
      within 1 of 255 levels (the loaded trajectory is a fresh tensor, the
      saved one a view: the CPU convolutions may round them apart, and the
      critics amplify it);
    * the eta check, and the card asked for where there is none."""
    from hedit_tpu_torch.edit.face_swap import h_edit_r_face as lib_h_edit
    from hedit_tpu_torch.io_utils.images import image_grid, load_image, to_pil
    from hedit_tpu_torch.models.arcface import cosine_sim
    from hedit_tpu_torch.pipelines.face import create_face_pipeline
    from hedit_tpu_torch.rewards.face_mask import build_face_mask

    rs = np.random.RandomState(5)
    for name in ("a", "b"):
        Image.fromarray(rs.randint(0, 255, (24, 20, 3), dtype=np.uint8)).save(tmp_path / f"{name}.png")
    ck = _write_checkpoints(tmp_path)
    base = ["--tiny", "--device", "cpu", "--num_diffusion_steps", "3", "--optimization_steps",
            "1", "--celeba_ckpt", ck["celeba"], "--arcface_ckpt", ck["arcface"],
            "--lpips_ckpt", ck["lpips"], "--parser_ckpt", ck["parser"]]
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")

    def run(out, *extra):
        assert main_face.main(base + ["--output_path", str(tmp_path / out), *extra]) == 0
        return capsys.readouterr().out

    def png(path):
        return np.asarray(Image.open(path)).astype(np.int16)

    printed = run("one", "--ref", a, "--source", b)
    run("no_blend", "--ref", a, "--source", b, "--post_processing")
    got = png(tmp_path / "one" / "item_a_b.png")

    pipe = create_face_pipeline(tiny=True, num_inference_steps=3, celeba_ckpt=ck["celeba"],
                                arcface_ckpt=ck["arcface"], lpips_ckpt=ck["lpips"],
                                parser_ckpt=ck["parser"], device="cpu")
    ref, src = (torch.from_numpy(load_image(p, size=16)) for p in (a, b))
    inv = invert_sde(pipe.unet, pipe.schedule, src, generator=torch.Generator().manual_seed(42))
    edited = lib_h_edit(pipe.unet, pipe.schedule, inv.xts[:, 3], inv.zs,
                        id_loss_fn=pipe.id_loss_fn(ref), lpips_loss_fn=pipe.lpips_loss_fn(src),
                        weight_edit_face=100.0, optimization_steps=1, after_skip_steps=3)
    mask = build_face_mask(pipe.parse(src))
    blended = edited * mask + src * (1 - mask)
    want = np.asarray(image_grid([to_pil(x.numpy()) for x in (ref, src, blended)]))
    diff = np.abs(got - want)
    assert diff.max() <= 3 and (diff > 0).mean() <= 0.15, (diff.max(), (diff > 0).mean())
    with torch.no_grad():
        sim = float(cosine_sim(pipe.arcface, blended, pipe.id_embed(ref)).mean())
    line = next(ln for ln in printed.splitlines() if ln.startswith("Cosine Similarity: "))
    assert abs(float(line.split(": ")[1]) - sim) <= 1e-5
    assert not np.array_equal(png(tmp_path / "no_blend" / "item_a_b.png"), got)

    data = tmp_path / "pairs.json"
    data.write_text(json.dumps([{"idx": 0, "ref": "a.png", "source": "b.png"},
                                {"idx": 1, "ref": "b.png", "source": "a.png"}]))
    run("dp", "--data_file", str(data), "--data_parallel", "2")
    args = main_face.parse_args(base + ["--ref", a, "--source", b])
    refs, srcs = torch.cat([ref, src]), torch.cat([src, ref])
    batched = main_face.edit_pairs(args, pipe, refs, srcs)
    for i, key in enumerate(("a_b", "b_a")):
        one = slice(i, i + 1)
        want = np.asarray(main_face.finish_pair(args, pipe, refs[one], srcs[one], batched[one]))
        np.testing.assert_array_equal(png(tmp_path / "dp" / f"item_{key}.png"), want)
    printed = run("dp", "--data_file", str(data), "--data_parallel", "2", "--resume")
    assert printed.count("skipping (--resume)") == 2
    for m in (pipe.unet, pipe.arcface, pipe.lpips):
        m.double()
    refs, srcs = refs.double(), srcs.double()
    batched = main_face.edit_pairs(args, pipe, refs, srcs)
    for i in range(2):
        one = main_face.edit_pairs(args, pipe, refs[i:i + 1], srcs[i:i + 1])
        assert batched.dtype == torch.float64 and (batched[i] - one[0]).abs().max() <= 1e-6

    traj = str(tmp_path / "traj.npz")
    run("ef_save", "--ref", a, "--source", b, "--mode", "ef", "--save_trajectory", traj)
    run("ef_load", "--ref", a, "--source", b, "--mode", "ef", "--load_trajectory", traj)
    assert np.abs(png(tmp_path / "ef_save" / "item_a_b.png")
                  - png(tmp_path / "ef_load" / "item_a_b.png")).max() <= 1

    with pytest.raises(ValueError):
        main_face.parse_args(["--ref", a, "--source", b, "--eta", "0.5"])
    assert main_face.parse_args(["--optimization_steps", "1"]).weight_edit_face == 100.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            main_face.main(["--tiny", "--ref", a, "--source", b])
