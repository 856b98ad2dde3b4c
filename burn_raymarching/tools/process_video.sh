#!/bin/bash
# Video → COLMAP sparse reconstruction driver (capture-chain stage 1).
#
# Behavioral equivalent of the reference's process_video.sh: frames are
# extracted at 10 fps as padded 1024x1024 squares, then COLMAP runs
# feature extraction → exhaustive matching → mapping → TXT export. The
# ffmpeg filter string and COLMAP thresholds are the interchange contract
# (reference process_video.sh:17-45) and are kept verbatim; everything
# else is this repo's own structure. Continue the chain with:
#   python -m burn_raymarching.tools.colmap_to_json  (TXT → cameras.json)
#   python -m burn_raymarching.tools.process_cameras (thin/filter/recenter)
#
# Usage: process_video.sh [video.mp4] [workdir]
set -euo pipefail

VIDEO_FILE="${1:-data/tomato.mp4}"
BASE_DIR="${2:-data/tomato}"
IMG_DIR="$BASE_DIR/images"
DB_PATH="$BASE_DIR/database.db"
SPARSE_DIR="$BASE_DIR/sparse"

log() { echo "[process_video] $*"; }

log "resetting workdir $BASE_DIR"
rm -rf "$BASE_DIR"
mkdir -p "$IMG_DIR" "$SPARSE_DIR"

log "extracting frames from $VIDEO_FILE (10 fps, 1024px padded square)"
ffmpeg -i "$VIDEO_FILE" \
  -vf "fps=10,scale=1024:1024:force_original_aspect_ratio=decrease,pad=1024:1024:(ow-iw)/2:(oh-ih)/2:black" \
  -q:v 2 "$IMG_DIR/img_%04d.jpg"

log "COLMAP feature extraction (single pinhole camera, CPU)"
colmap feature_extractor \
  --database_path "$DB_PATH" \
  --image_path "$IMG_DIR" \
  --ImageReader.single_camera 1 \
  --ImageReader.camera_model SIMPLE_PINHOLE \
  --FeatureExtraction.use_gpu 0

log "COLMAP exhaustive matching"
colmap exhaustive_matcher \
  --database_path "$DB_PATH" \
  --FeatureMatching.use_gpu 0

log "COLMAP mapping (relaxed thresholds for low-texture captures)"
colmap mapper \
  --database_path "$DB_PATH" \
  --image_path "$IMG_DIR" \
  --output_path "$SPARSE_DIR" \
  --Mapper.min_num_matches 10 \
  --Mapper.init_min_num_inliers 30

log "exporting model 0 as TXT"
colmap model_converter \
  --input_path "$SPARSE_DIR/0" \
  --output_path "$SPARSE_DIR/0" \
  --output_type TXT

log "done: cameras.txt / images.txt / points3D.txt in $SPARSE_DIR/0"
