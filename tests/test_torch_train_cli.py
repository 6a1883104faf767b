"""The port's training runtime around the kernels: its copy of minigin on
the repo's gin files, the configurables those files bind, the loggers,
``URMPDataModule``, ``TrainConfig.data_parallel`` and the CLI
``scripts/torch_train.py`` on the CPU, with its resume and lazy loading. Where the JAX package has the same
piece (minigin, the CSV logger) the two are held against each other."""
import csv
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from neural_waveshaping_synthesis_tpu import minigin as jgin
from neural_waveshaping_synthesis_tpu.training.logging import CSVLogger as JCSVLogger
from neural_waveshaping_synthesis_tpu_torch import minigin as gin
from neural_waveshaping_synthesis_tpu_torch.data import GeneralDataModule, URMPDataModule
from neural_waveshaping_synthesis_tpu_torch.inference import Synthesizer
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping
from neural_waveshaping_synthesis_tpu_torch.training import CSVLogger, TrainConfig, Trainer
from neural_waveshaping_synthesis_tpu_torch.training import trainer as trainer_module

REPO = Path(__file__).resolve().parents[1]
TRAIN_GIN = "gin/train/train_newt.gin"


@pytest.fixture(autouse=True)
def clean_gin():
    """Bindings are process-wide: start and leave every test with none."""
    gin.clear_config()
    yield
    gin.clear_config()


@pytest.fixture(scope="module")
def cli():
    spec = importlib.util.spec_from_file_location("torch_train", REPO / "scripts" / "torch_train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _n_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


def test_train_gin_parses_and_builds_the_shipped_model(cli):
    """gin/train/train_newt.gin (which includes gin/models/newt.gin) binds
    only names the port registers (validate_config finds no problem), and
    builds the shipped architecture, 266,945 parameters, with the recipe's
    NEWT.fused, TrainConfig and batch size."""
    gin.parse_config_file(TRAIN_GIN)
    assert gin.validate_config() == []
    model = cli.get_model()
    assert isinstance(model, NeuralWaveshaping) and _n_params(model) == 266_945
    assert model.newt.fused == "full_lane_cr" and model.osc.n_harmonics == 101
    assert model.noise_synth.ir_length == 256 and model.reverb.ir.shape == (2 * 16000 - 1,)
    cfg = TrainConfig()
    assert (cfg.max_steps, cfg.lr_decay_interval, cfg.gradient_clip_val, cfg.data_parallel) == (
        120000, 10000, 2.0, True)


def test_operative_config_matches_the_jax_minigin():
    """The port's copy of minigin reads the gin files as the JAX one does:
    the same macros and bindings, rendered the same."""
    jgin.clear_config()
    try:
        jgin.parse_config_file(TRAIN_GIN)
        jgin.parse_config("NEWT.fused = 'full_lane'")
        gin.parse_config_file(TRAIN_GIN)
        gin.parse_config("NEWT.fused = 'full_lane'")
        assert gin.operative_config_str() == jgin.operative_config_str()
    finally:
        jgin.clear_config()


@pytest.mark.parametrize("binding,expect", [
    ("'full_lane'", "full_lane"), ("'fl'", "fl"), ("True", True), ("False", False), ("'cr'", "cr"),
])
def test_a_binding_reaches_newt_fused(cli, binding, expect):
    gin.parse_config_file(TRAIN_GIN)
    gin.parse_config(f"NEWT.fused = {binding}")
    assert cli.get_model().newt.fused == expect


def test_the_bf16_gin_file_stops_at_the_mixed_precision_item(cli, tmp_path):
    """gin/train/train_newt_bf16.gin binds NeuralWaveshaping.compute_dtype =
    'bfloat16' and NEWT.fused = None (the chain): validate_config finds every
    binding a parameter the port takes, the CLI's model is the bf16 one, and
    the CLI, which stopped here before mixed precision was ported, trains 2
    steps on the CPU with finite losses and writes its checkpoint, whose
    parameters are float32 and which serves in float32."""
    gin.parse_config_file("gin/train/train_newt_bf16.gin")
    assert gin.validate_config() == []
    model = cli.get_model()
    assert model.compute_dtype == "bfloat16" and model.newt.fused is None
    gin.clear_config()
    import chip_smoke

    root = chip_smoke.write_tone_dataset(tmp_path / "data", splits=(("train", 4), ("val", 2)), seconds=0.25)
    rc = cli.main([
        "--gin-file", "gin/train/train_newt_bf16.gin", "--dataset-path", root, "--device", "cpu",
        "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-dir", str(tmp_path / "logs"),
        "-b", "TrainConfig.max_steps = 2", "-b", "GeneralDataModule.batch_size = 2",
        "-b", "TrainConfig.log_every_n_steps = 1", "-b", "TrainConfig.val_every_n_steps = 2",
    ])
    assert rc == 0
    with open(tmp_path / "logs" / "metrics.csv") as f:
        train_rows = [r for r in csv.DictReader(f) if r["train/loss"]]
    assert [r["step"] for r in train_rows] == ["1", "2"]
    assert all(np.isfinite(float(r[k])) for r in train_rows for k in ("train/loss", "grad_norm"))
    gin.clear_config()
    synth = Synthesizer.from_checkpoint(str(tmp_path / "ckpt" / "best.ckpt"), device="cpu")
    assert synth.model.compute_dtype == "float32"
    assert {t.dtype for t in synth.model.parameters()} == {torch.float32}


@pytest.mark.parametrize("out_mixer", [False, True])
def test_fuse_bindings_engage_the_fused_path_under_the_recipe(cli, monkeypatch, out_mixer):
    """-b "NeuralWaveshaping.fuse_exciter = True" (and fuse_out_mixer) reach
    the CLI's model, and with the recipe's NEWT.fused = 'full_lane_cr' at
    hop 128 its forward takes the exciter-fused path (one call of the xcr,
    or the xfull, wrapper)."""
    from neural_waveshaping_synthesis_tpu_torch.kernels import newt_fused as nf

    gin.parse_config_file(TRAIN_GIN)
    gin.parse_config("NeuralWaveshaping.fuse_exciter = True")
    gin.parse_config(f"NeuralWaveshaping.fuse_out_mixer = {out_mixer}")
    assert gin.validate_config() == []
    model = cli.get_model(generator=torch.Generator().manual_seed(0))
    assert model.fuse_exciter and model.fuse_out_mixer == out_mixer
    assert model.newt.fused == "full_lane_cr" and model.control_hop == 128
    calls = []
    name = "bank_newt_xfull" if out_mixer else "bank_film_shaper_xcr"
    real = getattr(nf, name)
    monkeypatch.setattr(nf, name, lambda *a, **k: calls.append(name) or real(*a, **k))
    with torch.no_grad():
        audio = model(torch.full((1, 4), 330.0), torch.zeros(1, 4, 2),
                      generator=torch.Generator().manual_seed(1))
    assert calls == [name] and audio.shape == (1, 4 * 128) and torch.isfinite(audio).all()


def test_a_scoped_binding_reaches_only_the_noise_mlp():
    """``noise_synth/TimeDistributedMLP.*`` sizes the noise branch's MLP and
    no other TimeDistributedMLP (NEWT's FiLM MLP keeps its width), as the
    JAX model's ``_default_noise_mlp``; unscoped bindings reach the
    submodules the model builds."""
    gin.parse_config_file(TRAIN_GIN)
    gin.parse_config("noise_synth/TimeDistributedMLP.hidden_size = 32")
    gin.parse_config("HarmonicOscillator.n_harmonics = 50")
    gin.parse_config("Reverb.length_in_seconds = 1")
    model = NeuralWaveshaping(generator=torch.Generator().manual_seed(0))
    assert [d.w.shape for d in model.h_generator.dense] == [(128, 32), (32, 32), (32, 32), (32, 129)]
    assert [d.w.shape[1] for d in model.newt.mlp.dense] == [128, 128, 128, 256]
    assert model.osc.n_harmonics == 50 and model.harmonic_mixer.w.shape == (50, 64)
    assert model.reverb.ir.shape == (16000 - 1,)


def test_no_binding_keeps_the_seeded_init():
    """With no bindings the model is the shipped architecture, and a
    seeded generator gives the same tensors as under the recipe's
    bindings (which restate the defaults)."""
    plain = NeuralWaveshaping(generator=torch.Generator().manual_seed(4))
    gin.parse_config_file(TRAIN_GIN)
    bound = NeuralWaveshaping(generator=torch.Generator().manual_seed(4))
    assert _n_params(plain) == 266_945
    assert all(torch.equal(a, b) for a, b in zip(plain.state_dict().values(), bound.state_dict().values()))


def test_urmp_datamodule_takes_its_own_batch_size(tmp_path):
    """root/<instrument> holds the shards; a URMPDataModule.batch_size
    binding wins over GeneralDataModule's (JAX data/urmp.py passes it by
    keyword for this)."""
    import chip_smoke

    chip_smoke.write_tone_dataset(tmp_path / "vn", splits=(("train", 3), ("val", 1)), seconds=0.25)
    gin.parse_config("URMPDataModule.batch_size = 3\nGeneralDataModule.batch_size = 8")
    dm = URMPDataModule(str(tmp_path), "vn")
    assert dm.batch_size == 3 and dm.instrument == "vn"
    assert dm.data_root == str(tmp_path / "vn") and len(dm.dataset("train")) == 3
    assert GeneralDataModule(str(tmp_path / "vn")).batch_size == 8


def test_csv_logger_matches_the_jax_logger(tmp_path):
    """Same metrics -> the same metrics.csv (header and rows, the wall
    time aside) and the same audio snapshot wavs, as the JAX CSVLogger."""
    rows = [({"train/loss": 1.5, "train/lr": 1e-3, "train/steps_per_sec": 4.0, "grad_norm": 2.5}, 10),
            ({"val/loss": 1.25}, 10)]
    audio = np.sin(np.linspace(0, 100, 4000)).astype(np.float32)
    for logger in (CSVLogger(str(tmp_path / "port")), JCSVLogger(str(tmp_path / "jax"))):
        for metrics, step in rows:
            logger.log_metrics(metrics, step)
        logger.log_audio("val/recon", audio, 16000, 10)
    tables = []
    for side in ("port", "jax"):
        with open(tmp_path / side / "metrics.csv") as f:
            tables.append([{k: v for k, v in r.items() if k != "time"} for r in csv.DictReader(f)])
    assert tables[0] == tables[1] and len(tables[0]) == 2
    wavs = [wavfile.read(tmp_path / side / "audio" / "val_recon_step10.wav") for side in ("port", "jax")]
    assert wavs[0][0] == wavs[1][0] and np.array_equal(wavs[0][1], wavs[1][1])


def test_cli_trains_on_the_cpu_and_its_checkpoint_serves(cli, tmp_path):
    """Two steps of the CLI on the CPU with the recipe and NEWT.fused =
    'full_lane' on the smoke's tone dataset: metrics.csv with the JAX
    columns and train and val rows, the validation audio beside it, and a
    checkpoint that Synthesizer.from_checkpoint(device="cpu") serves."""
    import chip_smoke

    root = chip_smoke.write_tone_dataset(tmp_path / "data", splits=(("train", 4), ("val", 2)), seconds=0.25)
    rc = cli.main([
        "--gin-file", TRAIN_GIN, "--dataset-path", root, "--device", "cpu",
        "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-dir", str(tmp_path / "logs"),
        "-b", "NEWT.fused = 'full_lane'", "-b", "TrainConfig.max_steps = 2",
        "-b", "GeneralDataModule.batch_size = 2", "-b", "TrainConfig.log_every_n_steps = 1",
        "-b", "TrainConfig.val_every_n_steps = 2",
    ])
    assert rc == 0
    with open(tmp_path / "logs" / "metrics.csv") as f:
        reader = csv.DictReader(f)
        table = list(reader)
    assert reader.fieldnames == ["step", "time", "train/loss", "train/lr", "train/steps_per_sec",
                                 "val/loss", "test/loss", "grad_norm"]
    train_rows = [r for r in table if r["train/loss"]]
    assert [r["step"] for r in train_rows] == ["1", "2"]
    assert all(np.isfinite(float(r[k])) for r in train_rows for k in ("train/loss", "grad_norm"))
    assert [r["step"] for r in table if r["val/loss"]] == ["2"]
    assert sorted(p.name for p in (tmp_path / "logs" / "audio").iterdir()) == [
        "val_original_step2.wav", "val_recon_step2.wav"]
    gin.clear_config()
    synth = Synthesizer.from_checkpoint(str(tmp_path / "ckpt" / "best.ckpt"), device="cpu")
    f0 = np.geomspace(220.0, 440.0, 40).astype(np.float32)
    audio = synth.render([(f0, np.full_like(f0, -15.0))], seed=0)[0]
    assert audio.shape == (40 * 128,) and np.all(np.isfinite(audio))


def _cli_run(cli, root, tmp_path, steps, *extra):
    rc = cli.main([
        "--gin-file", TRAIN_GIN, "--dataset-path", root, "--device", "cpu",
        "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-dir", str(tmp_path / "logs"),
        "-b", f"TrainConfig.max_steps = {steps}", "-b", "GeneralDataModule.batch_size = 2",
        "-b", "TrainConfig.log_every_n_steps = 1", "-b", "TrainConfig.val_every_n_steps = 2",
        *extra,
    ])
    gin.clear_config()
    with open(tmp_path / "logs" / "metrics.csv") as f:
        return rc, list(csv.DictReader(f))


def test_cli_restore_checkpoint_continues_a_run(cli, tmp_path, capsys):
    """--restore-checkpoint continues a 4-step run to 8: it says it resumed
    from step 4, and metrics.csv's train and val steps go on without a
    repeat (1-8, and 2, 4, 6, 8)."""
    import chip_smoke

    root = chip_smoke.write_tone_dataset(tmp_path / "data", splits=(("train", 4), ("val", 2)), seconds=0.25)
    assert _cli_run(cli, root, tmp_path, 4)[0] == 0
    rc, table = _cli_run(cli, root, tmp_path, 8, "--restore-checkpoint")
    assert rc == 0 and "[trainer] resumed from step 4" in capsys.readouterr().out
    assert [int(r["step"]) for r in table if r["train/loss"]] == list(range(1, 9))
    assert [int(r["step"]) for r in table if r["val/loss"]] == [2, 4, 6, 8]


def test_cli_trains_without_loading_the_data_to_memory(cli, tmp_path, monkeypatch):
    """--no-load-data-to-memory hands the Trainer a lazy data module, whose
    run logs the same losses as the eager one, bit for bit."""
    import chip_smoke

    root = chip_smoke.write_tone_dataset(tmp_path / "data", splits=(("train", 4), ("val", 2)), seconds=0.25)
    modules = []
    real = trainer_module.Trainer.fit
    monkeypatch.setattr(trainer_module.Trainer, "fit",
                        lambda self, data, **kw: modules.append(data) or real(self, data, **kw))
    runs = [_cli_run(cli, root, tmp_path / name, 2, *flag)
            for name, flag in (("eager", ()), ("lazy", ("--no-load-data-to-memory",)))]
    assert [m.load_to_memory for m in modules] == [True, False]
    assert modules[1].dataset("train").audio is None
    losses = [[r["train/loss"] for r in table if r["train/loss"]] for _, table in runs]
    assert losses[0] == losses[1] and len(losses[0]) == 2


def test_data_parallel_over_several_cards_raises(monkeypatch):
    """TrainConfig.data_parallel (default True, as JAX) over one card is a
    mesh of one; a process that sees more than one card and belongs to no
    process group is refused, naming the launcher that runs one process per
    card (checked before anything touches a card). With data_parallel off it
    trains on its one card."""
    monkeypatch.setattr(trainer_module, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        Trainer(NeuralWaveshaping(), TrainConfig(), device="cuda")
    assert Trainer(NeuralWaveshaping(), TrainConfig(), device="cpu").cfg.data_parallel
    monkeypatch.setattr(torch.nn.Module, "to", lambda self, *a, **k: self)  # no card here
    one_card = Trainer(NeuralWaveshaping(), TrainConfig(data_parallel=False), device="cuda")
    assert one_card.mesh.world_size == 1 and not one_card.mesh.distributed
