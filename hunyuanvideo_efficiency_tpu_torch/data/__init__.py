"""Dataset tooling (JAX counterpart: data/; reference: dataset_processor/):
the `.pt` video / latent tensor dataset, mp4 and raw YUV to tensors, and
per-video bitrates. The video readers and writers import OpenCV (cv2) when
called."""
from .dataset_loader import VideoTensorDataset, save_tensor
from .mp42tensor import convert_dir, tensor_to_video, video_to_tensor
from .video_bit_rate import video_bit_rate, write_bitrate_table
from .yuv_tensor import parse_geometry, read_yuv, yuv_to_mp4, yuv_to_tensor

__all__ = [
    "VideoTensorDataset", "save_tensor", "convert_dir", "tensor_to_video",
    "video_to_tensor", "video_bit_rate", "write_bitrate_table",
    "parse_geometry", "read_yuv", "yuv_to_mp4", "yuv_to_tensor",
]
