"""``python -m spark_rapids_tpu_torch.native``: build every host library
source ahead of first use (a failed build raises with g++'s output)."""

from spark_rapids_tpu_torch.native import BUILD_DIR, build

for _src, _secs in build().items():
    print(f"built {_src}.cpp in {_secs:.1f} s into {BUILD_DIR}")
