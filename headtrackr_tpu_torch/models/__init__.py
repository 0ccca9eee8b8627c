"""Detector, camshift, head pose and the per-stream state machine."""
