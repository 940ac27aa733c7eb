#!/usr/bin/env bash
# End-to-end LibriSpeech recipe on the PyTorch port (counterpart of the
# repository's run.sh: the same stages, published-result defaults, RUN_*
# overrides and directory layout under RUN_WORKDIR), driving
# `python3 -m automatic_speech_recognition_torch.<stage>` and the port's
# tools/.  bpe-5k / mfcc 13x(+d,dd), enc 512x4 (+2 stride-2 convs), dec
# 1024x2, location-aware attention, lr 1e-4, 100 epochs, beam 8,
# convert_rate 0.12.
#
# Usage: bash automatic_speech_recognition_torch/run.sh [stage]
#        (default: run every stage in order; paths are relative to the
#        current directory, as run.sh's are)
#
# Two differences from run.sh, both forced by the port:
# - RUN_DEVICE (default cuda) is passed as --device to every stage that
#   runs a model or the frontend; never to the host-only subword and
#   shards stages, nor to the corpus synthesis.
# - The train stage uses every local GPU, as train.py uses every local
#   device: with more than one it runs the port's launcher (python3 -m
#   automatic_speech_recognition_torch.parallel.launch --nproc_per_node
#   <count>: torchrun --standalone, one process per GPU, exiting with the
#   first failing rank's code, so 17 and 18 reach the supervisor); with
#   one, plain python3 -m on the first GPU.  RUN_NPROC overrides the
#   count (bucket batch sizes must divide by it).  A RUN_DEVICE list
#   (cuda:0,cuda:2) goes to train as it is, which starts a rank per
#   device itself.
set -euo pipefail

stage="${1:-all}"

# the port's package resolves from any working directory
repo=$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)
export PYTHONPATH="$repo${PYTHONPATH:+:$PYTHONPATH}"
port=automatic_speech_recognition_torch

# ---- recipe hyperparameters (run.sh's, with its RUN_* overrides) ----
unit=${RUN_UNIT:-subword}
size=${RUN_BPE_SIZE:-5000}
feat_type=mfcc
feat_dim=${RUN_FEAT_DIM:-13}
enc_units=${RUN_ENC_UNITS:-512}
dec_units=${RUN_DEC_UNITS:-1024}
embedding_size=${RUN_EMBEDDING_SIZE:-256}
attention_size=${RUN_ATTENTION_SIZE:-128}
num_enc_layers=${RUN_NUM_ENC_LAYERS:-4}
num_dec_layers=${RUN_NUM_DEC_LAYERS:-2}
mode=loc
dropout_rate=0.0
lr=${RUN_LR:-1e-4}
epoch=${RUN_EPOCH:-100}
grad_clip=5
beam_size=${RUN_BEAM_SIZE:-8}
convert_rate=${RUN_CONVERT_RATE:-0.12}
lm_epochs=${RUN_LM_EPOCHS:-10}
device=${RUN_DEVICE:-cuda}

workdir=${RUN_WORKDIR:-.}
feat_dir=$workdir/data/LibriSpeech/features
shard_dir=$workdir/data/shards
subword_dir=$workdir/subword/
save_dir=$workdir/model/las/
log_dir=$workdir/log/
lm_dir=$workdir/lang/output/

# RUN_EXTRA_FLAGS: appended verbatim (e.g. fixture corpus dirs, tiny
# bucket tables); empty in the published recipe
common_flags="--unit $unit --feat_type $feat_type --feat_dim $feat_dim \
  --enc_units $enc_units --dec_units $dec_units \
  --embedding_size $embedding_size --attention_size $attention_size \
  --num_enc_layers $num_enc_layers --num_dec_layers $num_dec_layers \
  --mode $mode --dropout_rate $dropout_rate --lr $lr --grad_clip $grad_clip \
  --feat_dir $feat_dir --shard_dir $shard_dir --subword_dir $subword_dir \
  --save_dir $save_dir --log_dir $log_dir --lm_dir $lm_dir \
  ${RUN_EXTRA_FLAGS:-}"

run_stage() { [[ "$stage" == "all" || "$stage" == "$1" ]]; }

# the train stage's command and --device: plain cuda is every local GPU
# (RUN_NPROC overrides the count; at 1, plain cuda is the first GPU)
train_launcher() {
  local nproc=${RUN_NPROC:-} dev=$device
  if [[ -z "$nproc" ]]; then
    if [[ "$device" == cuda ]]; then
      nproc=$(python3 -c "import torch; print(torch.cuda.device_count())")
    else
      nproc=1
    fi
  fi
  if (( nproc > 1 )); then
    echo python3 -m $port.parallel.launch \
      --nproc_per_node "$nproc" -m $port.train --device "$dev"
  else
    if [[ "$dev" == cuda ]]; then
      dev=cuda:0
    fi
    echo python3 -m $port.train --device "$dev"
  fi
}

# optional stage (NOT in "all"): synthesize a speech corpus when the
# LibriSpeech download is unavailable (no egress)
if [[ "$stage" == "synth" ]]; then
  echo "=== stage: synthesize formant-speech corpus ==="
  python3 -m $port.tools.synth_corpus --out data/synth \
    --train_utts 4000 --dev_utts 300 --test_utts 300
  exit 0
fi

if run_stage subword; then
  echo "=== stage: train subword tokenizer (bpe-$size) ==="
  python3 -m $port.train_subword $common_flags --size $size
fi

if run_stage preprocess; then
  echo "=== stage: preprocess (on-device frontend) ==="
  python3 -m $port.preprocess --device $device $common_flags
fi

if run_stage shards; then
  echo "=== stage: pack ARSH shards ==="
  python3 -m $port.create_shards $common_flags
fi

if run_stage train; then
  echo "=== stage: train LAS ($epoch epochs) ==="
  # supervised: retries stall-watchdog (17) and transient-platform (18)
  # exits, resuming from the last epoch checkpoint
  $repo/$port/tools/train_supervised.sh 24 -- \
    $(train_launcher) $common_flags --epoch $epoch \
      --scheduled_sampling False --scan_unroll 4 --stall_timeout_s 900
fi

# ---- measured-recommended variant (NOT in "all"): joint CTC 0.2 and
# joint log-prob beam decoding, as in run.sh ----
if [[ "$stage" == "train_rec" ]]; then
  echo "=== stage: train LAS, recommended joint-CTC recipe ==="
  $repo/$port/tools/train_supervised.sh 24 -- \
    $(train_launcher) $common_flags --epoch $epoch \
      --scheduled_sampling False --ctc True --ctc_weight 0.2 \
      --scan_unroll 4 --stall_timeout_s 900
fi

if [[ "$stage" == "decode_rec" ]]; then
  echo "=== stage: beam decode, recommended joint scoring ==="
  python3 -m $port.decode --device $device $common_flags --split dev \
    --beam_size $beam_size --convert_rate $convert_rate \
    --restore_epoch -1 --ctc True \
    --beam_logprob True --ctc_beam_weight 0.5
fi

if run_stage test; then
  echo "=== stage: greedy eval ==="
  python3 -m $port.test --device $device $common_flags --split dev \
    --convert_rate $convert_rate --scan_unroll 4
fi

if run_stage lm; then
  echo "=== stage: train char RNNLM ==="
  python3 -m $port.train_lm --device $device \
    --data_file $subword_dir/corpus_all.txt \
    --output_dir $lm_dir --num_epochs $lm_epochs ${RUN_LM_FLAGS:-}
fi

if run_stage decode; then
  echo "=== stage: beam decode (beam $beam_size) ==="
  python3 -m $port.decode --device $device $common_flags --split dev \
    --beam_size $beam_size --convert_rate $convert_rate \
    --restore_epoch -1
fi

if run_stage decode_lm; then
  echo "=== stage: beam decode + RNNLM fusion ==="
  python3 -m $port.decode --device $device $common_flags --split dev \
    --beam_size $beam_size --convert_rate $convert_rate \
    --restore_epoch -1 --apply_lm True --lm_weight 0.5
fi
