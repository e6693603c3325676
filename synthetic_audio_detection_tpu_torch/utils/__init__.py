"""Host-side configuration and calibration helpers."""
