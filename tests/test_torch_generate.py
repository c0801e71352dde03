"""`dnet-torch-generate` (dnet_tpu_torch/cli/generate.py) against the
reference's `dnet-generate` (dnet_tpu/cli/generate.py).

On the tiny Llama with f32 params, both CLIs read the same prompts file
and write JSONL rows to a file: each row's prompt, text and token count
must be equal (tok_s is each run's own rate), with the chat template and
with --raw.  The refusals exit 2 with the reference's messages; --mesh
sp=2 on the CPU gives the local engine's rows, and with --spec the
reference's; a multi-process pod exits 2.
"""

import json

import pytest

from dnet_tpu.config import reset_settings_cache

pytestmark = [pytest.mark.api]

PROMPTS = ["Hello there", "Tell me a story about GPUs"]
COMMON = ["--max-tokens", "8", "--max-seq", "64", "--param-dtype", "float32"]


@pytest.fixture
def env(monkeypatch):
    def set_env(values: dict):
        for k, v in values.items():
            monkeypatch.setenv(k, v)
        reset_settings_cache()

    yield set_env
    reset_settings_cache()


@pytest.fixture(scope="module")
def prompts_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("prompts") / "prompts.txt"
    path.write_text("\n".join(PROMPTS) + "\n\n")
    return path


def _rows(main, model_dir, prompts_file, out, *extra) -> list:
    assert main(["--model", str(model_dir), "--prompts", str(prompts_file), "--output", str(out), *COMMON,
                 *extra]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert all(set(r) == {"prompt", "text", "tokens", "tok_s"} for r in rows)
    return [(r["prompt"], r["text"], r["tokens"]) for r in rows]


def _port_main(argv):
    from dnet_tpu_torch.cli.generate import main

    return main(argv)


def _ref_main(argv):
    from dnet_tpu.cli.generate import main

    return main(argv)


@pytest.mark.parametrize("raw", [False, True], ids=["chat", "raw"])
def test_rows_match_the_reference(tiny_llama_dir, prompts_file, tmp_path, raw):
    extra = ["--raw"] if raw else []
    port = _rows(_port_main, tiny_llama_dir, prompts_file, tmp_path / "port.jsonl", *extra, "--device", "cpu")
    ref = _rows(_ref_main, tiny_llama_dir, prompts_file, tmp_path / "ref.jsonl", *extra)
    assert [p for p, _, _ in port] == PROMPTS
    assert all(n > 0 for _, _, n in port)
    assert port == ref


@pytest.mark.parametrize("case", ["draft-without-spec", "draft-with-mesh", "missing-model", "missing-draft"])
def test_refusals_match_the_reference(tiny_llama_dir, prompts_file, tmp_path, capsys, case):
    model = str(tiny_llama_dir)
    argv = {
        "draft-without-spec": ["--model", model, "--draft", model],
        "draft-with-mesh": ["--model", model, "--draft", model, "--spec", "2", "--mesh", "sp=2"],
        "missing-model": ["--model", str(tmp_path / "nope")],
        "missing-draft": ["--model", model, "--draft", str(tmp_path / "nope"), "--spec", "2"],
    }[case] + ["--prompts", str(prompts_file), *COMMON]
    errors = []
    for main, extra in ((_ref_main, []), (_port_main, ["--device", "cpu"])):
        assert main(argv + extra) == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1]


def test_sp_mesh_gives_the_local_rows(tiny_llama_dir, prompts_file, tmp_path):
    local = _rows(_port_main, tiny_llama_dir, prompts_file, tmp_path / "local.jsonl", "--device", "cpu")
    mesh = _rows(_port_main, tiny_llama_dir, prompts_file, tmp_path / "mesh.jsonl", "--device", "cpu",
                 "--mesh", "sp=2")
    assert mesh == local


@pytest.mark.parametrize("argv,env_values,needle", [
    (["--mesh", "tp=2"], {}, "mesh tp=2"),
    (["--mesh", "sp=2", "--spec", "2"], {}, None),
    ([], {"DNET_MESH_NUM_PROCESSES": "2"}, "ROADMAP A7"),
], ids=["tp-mesh", "spec-under-mesh", "multi-process-pod"])
def test_port_refuses_what_it_does_not_serve(tiny_llama_dir, prompts_file, tmp_path, capsys, env, argv, env_values,
                                             needle):
    """The refusals exit 2 naming what is not ported; --spec under a mesh
    (needle None) serves now, as the reference's does: prompt lookup under
    sp = 2 gives the reference's rows."""
    env(env_values)
    if needle is None:
        got = _rows(_port_main, tiny_llama_dir, prompts_file, tmp_path / "port.jsonl", "--device", "cpu", *argv)
        assert got == _rows(_ref_main, tiny_llama_dir, prompts_file, tmp_path / "ref.jsonl", *argv)
        return
    assert _port_main(["--model", str(tiny_llama_dir), "--prompts", str(prompts_file), "--device", "cpu", *COMMON,
                       *argv]) == 2
    assert needle in capsys.readouterr().err
