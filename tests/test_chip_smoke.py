"""chip_smoke.py's contract where there is no GPU: it refuses to run, and
prints no result line; and the result line it prints on the card."""

import json

import pytest

import chip_smoke


class _Dev:
    def __init__(self, platform, kind):
        self.platform = platform
        self.device_kind = kind


def test_result_line_is_the_contract():
    devs = [_Dev("gpu", "NVIDIA H100 80GB HBM3")] * 4
    line = chip_smoke.result_line(devs)
    assert json.loads(line) == {
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": "NVIDIA H100 80GB HBM3",
            "count": 4,
        },
    }
    assert "\n" not in line


@pytest.mark.parametrize(
    "platforms", [["cpu"], ["gpu", "cpu"], [], ["rocm"]]
)
def test_require_gpu_refuses_other_platforms(platforms):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu([_Dev(p, p) for p in platforms])
    assert exc.value.code not in (0, None)


def test_require_gpu_accepts_gpus():
    chip_smoke.require_gpu([_Dev("gpu", "H100")] * 2)


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_main_on_cpu_exits_without_result(argv, capsys, monkeypatch):
    ran = []
    monkeypatch.setattr(chip_smoke, "load_season", lambda: ran.append(1))
    monkeypatch.setattr(chip_smoke, "card_lines", lambda: ran.append(1))
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out
    assert not ran


def test_check_raises():
    chip_smoke.check(True, "fine")
    with pytest.raises(chip_smoke.SmokeFailure, match="broken"):
        chip_smoke.check(False, "broken")
