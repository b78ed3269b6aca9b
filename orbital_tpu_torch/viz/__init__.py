"""Offline visualization: matplotlib orbit plots and ffmpeg video export."""
