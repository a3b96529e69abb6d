# -*- coding: utf-8 -*-
# Protocol buffer code for tpu_metrics.proto.
#
# The serialized FileDescriptorProto below is the one vtpu's
# proto/gen_tpu_metrics.py builds with the protobuf runtime (this image
# has no protoc), byte for byte: the wire, and the descriptor a process
# that loads both packages registers under "tpu_metrics.proto", are one.
# Do not edit by hand.
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database

_sym_db = _symbol_database.Default()

from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2  # noqa: E402,F401


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x11tpu_metrics.proto\x12\x1ftpu.monitoring.runtime.v2alpha1\x1a\x1fgoogle/protobuf/timestamp.proto"U\n\tAttrValue\x12\x12\n\x08int_attr\x18\x01 \x01(\x03H\x00\x12\x15\n\x0bdouble_attr\x18\x02 \x01(\x01H\x00\x12\x15\n\x0bstring_attr\x18\x03 \x01(\tH\x00B\x06\n\x04attr"S\n\tAttribute\x12\x0b\n\x03key\x18\x01 \x01(\t\x129\n\x05value\x18\x02 \x01(\x0b2*.tpu.monitoring.runtime.v2alpha1.AttrValue"_\n\x05Gauge\x12\x10\n\x06as_int\x18\x01 \x01(\x03H\x00\x12\x13\n\tas_double\x18\x02 \x01(\x01H\x00\x12\x13\n\tas_string\x18\x03 \x01(\tH\x00\x12\x11\n\x07as_bool\x18\x04 \x01(\x08H\x00B\x07\n\x05value"\xb4\x01\n\x06Metric\x12=\n\tattribute\x18\x01 \x01(\x0b2*.tpu.monitoring.runtime.v2alpha1.Attribute\x12-\n\ttimestamp\x18\x02 \x01(\x0b2\x1a.google.protobuf.Timestamp\x127\n\x05gauge\x18\x03 \x01(\x0b2&.tpu.monitoring.runtime.v2alpha1.GaugeH\x00B\x03\n\x01m"h\n\tTPUMetric\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x13\n\x0bdescription\x18\x02 \x01(\t\x128\n\x07metrics\x18\x03 \x03(\x0b2\'.tpu.monitoring.runtime.v2alpha1.Metric"$\n\rMetricRequest\x12\x13\n\x0bmetric_name\x18\x01 \x01(\t"L\n\x0eMetricResponse\x12:\n\x06metric\x18\x01 \x01(\x0b2*.tpu.monitoring.runtime.v2alpha1.TPUMetric"\x1d\n\x1bListSupportedMetricsRequest"&\n\x0fSupportedMetric\x12\x13\n\x0bmetric_name\x18\x01 \x01(\t"j\n\x1cListSupportedMetricsResponse\x12J\n\x10supported_metric\x18\x01 \x03(\x0b20.tpu.monitoring.runtime.v2alpha1.SupportedMetric2\xa1\x02\n\x14RuntimeMetricService\x12s\n\x10GetRuntimeMetric\x12..tpu.monitoring.runtime.v2alpha1.MetricRequest\x1a/.tpu.monitoring.runtime.v2alpha1.MetricResponse\x12\x93\x01\n\x14ListSupportedMetrics\x12<.tpu.monitoring.runtime.v2alpha1.ListSupportedMetricsRequest\x1a=.tpu.monitoring.runtime.v2alpha1.ListSupportedMetricsResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tpu_metrics_pb2', globals())
