# needle-tpu container image (analog of the reference's two-stage Dockerfile).
#
# Stage 1 builds the native ingest extension and C API against FFmpeg dev
# headers; stage 2 is the slim runtime with only shared libs + the package.
# For GPU hosts, install jax[cuda12] in place of jax[cpu] below: the search
# kernel is a Pallas kernel through Triton and needs JAX's CUDA plugin.

FROM python:3.12-slim AS build
RUN apt-get update && apt-get install -y --no-install-recommends \
    g++ make libavformat-dev libavcodec-dev libavutil-dev libswresample-dev \
    && rm -rf /var/lib/apt/lists/*
WORKDIR /src
COPY . .
RUN make -C native && make -C capi \
    && pip install --no-cache-dir build && python -m build --wheel

FROM python:3.12-slim
RUN apt-get update && apt-get install -y --no-install-recommends \
    libavformat59 libavcodec59 libavutil57 libswresample4 \
    && rm -rf /var/lib/apt/lists/* || true
COPY --from=build /src/dist/*.whl /tmp/
RUN pip install --no-cache-dir /tmp/*.whl jax[cpu] && rm /tmp/*.whl
COPY --from=build /src/native/libneedle_ingest.so /usr/local/lib/needle_tpu/native/
COPY --from=build /src/capi/libneedle_tpu_capi.so /usr/local/lib/needle_tpu/capi/
ENTRYPOINT ["needle-tpu"]
