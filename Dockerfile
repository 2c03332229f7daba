# Container build (parity with the reference Dockerfile packaging surface).
# External phasing tools (shapeit4, bcftools, bingraphsample) follow the
# reference's docker/ recipes and are required only for the haplotype stage.
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
    g++ make zlib1g-dev wget tabix bcftools \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/remixt-jax
COPY . .
RUN pip install --no-cache-dir .

ENTRYPOINT ["remixt-jax"]
